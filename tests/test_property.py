"""Property-based differential tests (hypothesis).

1. Native C++ CSV tokenizer vs the Python reference implementation on
   arbitrary generated rows (quotes, BOMs, commas, unicode, junk
   numerics) — the two parsers must agree exactly.
2. The fused Triton kernel (interpret mode) vs the oracle on generated
   catalogs with duplicates and near-ties — exact index parity must hold
   ALWAYS (lowest index wins every tie; this hunts for holes).
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from spotify_recommender_tpu.data import csv_ingest


field_text = st.text(
    alphabet=st.characters(
        blacklist_categories=("Cs",), blacklist_characters="\r\n"
    ),
    max_size=12,
)
numericish = st.one_of(
    st.floats(allow_nan=False, allow_infinity=False, width=32).map(str),
    st.sampled_from(["", "0", "-1.5", "1e3", "0x1p3", "nan", "abc",
                     "1.2.3", " 7 ", '"3.5"']),
    field_text,
)
keyish = st.sampled_from(
    ["C", "C#", "Db", "G#", "B", "5", "-1", "H", "", "c#", " A "]
)
modeish = st.sampled_from(["Major", "Minor", "major", "1", "0", "x", ""])


@st.composite
def csv_rows(draw):
    n = draw(st.integers(0, 6))
    rows = []
    for _ in range(n):
        fields = [
            draw(field_text),            # track_id
            draw(field_text),            # track_name
            draw(field_text),            # artists
            draw(field_text),            # album
        ]
        fields += [draw(numericish) for _ in range(2)]   # dance, energy
        fields += [draw(keyish)]
        fields += [draw(numericish)]                     # loudness
        fields += [draw(modeish)]
        fields += [draw(numericish) for _ in range(6)]   # rest
        fields += [draw(field_text)]                     # genre
        # quote some fields (embedded commas ride inside quotes)
        quoted = [
            f'"{f}"' if draw(st.booleans()) and '"' not in f else f
            for f in fields
        ]
        rows.append(",".join(quoted))
    return rows


HEADER = (
    "track_id,track_name,artists,album_name,danceability,energy,key,"
    "loudness,mode,speechiness,acousticness,instrumentalness,liveness,"
    "valence,tempo,track_genre"
)


class TestNativeParserDifferential:
    @settings(
        max_examples=150,
        deadline=None,
        suppress_health_check=[HealthCheck.too_slow],
    )
    @given(csv_rows())
    def test_native_equals_python(self, rows):
        from spotify_recommender_tpu.data import native_ingest

        if not native_ingest.available():
            pytest.skip("native parser not built")
        py = csv_ingest.parse_csv_rows(HEADER, rows)
        nat = native_ingest.parse_csv_rows_native(HEADER, rows)
        assert py.num_valid_rows == nat.num_valid_rows
        assert list(py.track_ids) == list(nat.track_ids)
        assert list(py.track_names) == list(nat.track_names)
        assert list(py.artists) == list(nat.artists)
        assert py.genre_names == nat.genre_names
        np.testing.assert_array_equal(py.genre_ids, nat.genre_ids)
        np.testing.assert_array_equal(py.raw_features, nat.raw_features)


class TestKernelProperty:
    @settings(
        max_examples=12,
        deadline=None,
        suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
    )
    @given(
        seed=st.integers(0, 2**31 - 1),
        n=st.integers(300, 3000),
        dup_frac=st.floats(0.0, 0.3),
        scale=st.sampled_from([1.0, 1e-4, 1e4]),
    )
    def test_always_matches_oracle(self, seed, n, dup_frac, scale):
        import jax.numpy as jnp

        from spotify_recommender_tpu.ops.pallas.fused_topk import fused_topk
        from spotify_recommender_tpu.ops.similarity import exact_topk

        rng = np.random.default_rng(seed)
        feats = (scale * rng.random((n, 12))).astype(np.float32)
        # inject duplicate rows (exact ties)
        ndup = int(dup_frac * n)
        if ndup:
            src = rng.integers(0, n, ndup)
            dst = rng.integers(0, n, ndup)
            feats[dst] = feats[src]
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        rows = rng.integers(0, n, 8).astype(np.int32)
        q = feats[rows]
        s, i = fused_topk(
            jnp.asarray(q), jnp.asarray(feats), jnp.asarray(norms),
            jnp.asarray(rows), jnp.int32(n), k=10, eps=1e-8, interpret=True,
        )
        rs, ri = exact_topk(
            jnp.asarray(q), jnp.asarray(feats), jnp.asarray(norms),
            exclude_rows=jnp.asarray(rows), k=10,
        )
        np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))
