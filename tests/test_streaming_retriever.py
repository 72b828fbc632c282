"""Host-streaming retrieval (catalogs beyond device memory): exactness +
memmap input."""

import numpy as np
import pytest

from spotify_recommender_tpu.retrieval.streaming_retriever import (
    StreamingRetriever,
)


class TestStreamingRetriever:
    def test_matches_oracle_small_windows(self, rng):
        import jax.numpy as jnp

        from spotify_recommender_tpu.ops.similarity import exact_topk

        feats = rng.random((20_000 + 17, 12), dtype=np.float32)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        rows = rng.integers(0, len(feats), 16).astype(np.int32)
        q = feats[rows]
        sr = StreamingRetriever(feats, norms, window=4096)
        s, i = sr(q, 10, exclude_rows=rows)
        rs, ri = exact_topk(
            jnp.asarray(q), jnp.asarray(feats), jnp.asarray(norms),
            exclude_rows=jnp.asarray(rows), k=10,
        )
        np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))
        np.testing.assert_array_equal(np.asarray(s), np.asarray(rs))

    def test_kernel_windows_match_oracle(self, rng):
        """Each window on the Triton kernel (interpret mode): window-local
        exclusions, a short last window and the merge across windows."""
        import jax.numpy as jnp

        from spotify_recommender_tpu.ops.similarity import exact_topk

        feats = rng.random((2_000 + 13, 12), dtype=np.float32)
        feats[1500] = feats[20]                  # a tie across windows
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        rows = np.asarray([20, 3, 1999, 2012], np.int32)
        q = feats[rows]
        sr = StreamingRetriever(feats, norms, window=512, interpret=True)
        s, i = sr(q, 10, exclude_rows=rows)
        rs, ri = exact_topk(
            jnp.asarray(q), jnp.asarray(feats), jnp.asarray(norms),
            exclude_rows=jnp.asarray(rows), k=10,
        )
        np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))
        np.testing.assert_allclose(
            np.asarray(s), np.asarray(rs), rtol=0, atol=1e-6
        )

    def test_streams_from_memmapped_catalog_dir(self, rng, tmp_path):
        """The capacity path end to end: memory-mapped catalog directory →
        windowed host→device streaming → exact results (no step ever
        holds the full catalog in device or host memory)."""
        import jax.numpy as jnp

        from conftest import make_songs_csv
        from spotify_recommender_tpu.data.catalog import Catalog
        from spotify_recommender_tpu.data.streaming import (
            preprocess_csv_streaming,
        )
        from spotify_recommender_tpu.ops.similarity import exact_topk

        p = make_songs_csv(tmp_path / "songs.csv", n_rows=600, seed=5)
        cat = preprocess_csv_streaming(
            str(p), str(tmp_path / "cat"), chunk_rows=128, use_native=False
        )
        assert isinstance(cat.features, np.memmap)
        sr = StreamingRetriever(cat.features, cat.norms, window=100)
        q = np.asarray(cat.features[:5], np.float32)
        s, i = sr(q, 7, exclude_rows=np.arange(5, dtype=np.int32))
        rs, ri = exact_topk(
            jnp.asarray(q), jnp.asarray(np.asarray(cat.features)),
            jnp.asarray(np.asarray(cat.norms)),
            exclude_rows=jnp.arange(5, dtype=jnp.int32), k=7,
        )
        np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))

    def test_norms_computed_windowed(self, rng):
        feats = rng.random((5000, 12), dtype=np.float32)
        sr = StreamingRetriever(feats, window=512)
        np.testing.assert_allclose(
            sr.norms, np.linalg.norm(feats, axis=1), rtol=1e-6
        )

    def test_duplicate_tie_rule(self, rng):
        feats = rng.random((3000, 12), dtype=np.float32)
        feats[700] = feats[100]
        feats[2900] = feats[100]
        sr = StreamingRetriever(feats, window=1000)
        _, i = sr(feats[100][None, :], 3)
        got = np.asarray(i)[0].tolist()
        assert got[0] == 100 and got.index(700) < got.index(2900)
