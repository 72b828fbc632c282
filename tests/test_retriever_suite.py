"""Retriever.retrieve against the transcription of the reference's CPU
scorer (conftest.reference_cpu_similarities / reference_topk), on whatever
path retrieval/path.choose_path picks for the platform and shape.

Tolerance: scores within 1e-6; indices equal except where the reference's
own adjacent scores lie within 1e-6 of each other (numpy and XLA sum the F
products in different orders).  Exact ties are held to the lowest-index
rule without that excuse.
"""

import numpy as np
import pytest

from spotify_recommender_tpu.core.config import RetrievalConfig
from spotify_recommender_tpu.data.catalog import Catalog
from spotify_recommender_tpu.retrieval.retriever import Retriever

from conftest import reference_cpu_similarities, reference_topk

TOL = 1e-6


def make_catalog(feats: np.ndarray) -> Catalog:
    n, f = feats.shape
    return Catalog(
        features=feats,
        norms=None,
        track_ids=np.asarray([f"t{i}" for i in range(n)], object),
        track_names=np.asarray([f"Song {i}" for i in range(n)], object),
        artists=np.asarray(["A"] * n, object),
        genre_ids=np.zeros(n, np.int32),
        genre_names=["g"],
        min_vals=np.zeros(f - 1, np.float32),
        max_vals=np.ones(f - 1, np.float32),
    )


def reference(queries, feats, excl, k):
    """(B, k) reference scores/rows; unfillable slots are (-inf, -1)."""
    b = len(queries)
    ref_s = np.full((b, k), -np.inf, np.float32)
    ref_i = np.full((b, k), -1, np.int64)
    for j in range(b):
        sims = reference_cpu_similarities(queries[j], feats)
        rows = reference_topk(sims, int(excl[j]), k)
        ref_i[j, : len(rows)] = rows
        ref_s[j, : len(rows)] = sims[rows]
    return ref_s, ref_i


def check(scores, rows, ref_s, ref_i):
    scores, rows = np.asarray(scores), np.asarray(rows)
    assert scores.shape == ref_s.shape and rows.shape == ref_i.shape
    filled = ref_i >= 0
    np.testing.assert_array_equal(rows[~filled], -1)
    assert np.all(np.isneginf(scores[~filled]))
    assert np.abs(scores[filled] - ref_s[filled]).max(initial=0) <= TOL
    gap = np.full(ref_s.shape, np.inf, np.float32)
    with np.errstate(invalid="ignore"):          # -inf - -inf in the tail
        d = ref_s[:, :-1] - ref_s[:, 1:]
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    strict = filled & ~(gap <= TOL)
    np.testing.assert_array_equal(rows[strict], ref_i[strict])
    # exact ties: lowest row first, wherever they sit
    for j in range(len(rows)):
        for a in range(rows.shape[1] - 1):
            if filled[j, a + 1] and scores[j, a] == scores[j, a + 1]:
                assert rows[j, a] < rows[j, a + 1]


CASES = [
    # id, n, f, b, k, exclude, modification
    ("one_row", 1, 12, 1, 1, False, None),
    ("tiny_exclusion", 37, 12, 3, 10, True, None),
    ("k32", 300, 12, 8, 32, True, None),
    ("f64_b64", 1003, 64, 64, 10, True, None),
    ("f64_b1_k32", 1003, 64, 1, 32, False, None),
    ("b64_k1", 2049, 12, 64, 1, True, None),
    ("b64_k32", 5000, 12, 64, 32, False, None),
    ("chunk_boundary_b3", 262_145, 12, 3, 10, True, None),
    ("chunk_boundary_b1", 262_145, 12, 1, 10, True, None),
    ("chunked_f64", 300_007, 64, 8, 32, False, None),
    ("duplicates", 500, 12, 8, 10, True, "dup"),
    ("duplicates_f64", 700, 64, 3, 32, False, "dup"),
    ("zero_norm_rows", 400, 12, 8, 32, True, "zero"),
    ("zero_norm_f64", 400, 64, 3, 10, False, "zero"),
    ("anti_aligned", 600, 12, 8, 10, True, "anti"),
    ("anti_aligned_f64", 600, 64, 3, 10, False, "anti"),
    ("k_past_valid_rows", 20, 12, 3, 32, True, None),
    ("k_equals_n", 10, 12, 3, 10, False, None),
    ("k_past_n_f64", 5, 64, 1, 32, True, None),
]


@pytest.mark.parametrize(
    "n,f,b,k,exclude,mod", [c[1:] for c in CASES], ids=[c[0] for c in CASES]
)
def test_retrieve_matches_reference(n, f, b, k, exclude, mod):
    rng = np.random.default_rng(n * 131 + f * 7 + b)
    feats = rng.random((n, f), dtype=np.float32)
    if mod == "dup":
        src = rng.integers(0, n, n // 10)
        feats[rng.integers(0, n, n // 10)] = feats[src]
        feats[[5, 9, 17]] = feats[3]
    if mod == "zero":
        feats[rng.integers(0, n, n // 8)] = 0.0
    rows = rng.integers(0, n, b)
    if mod == "dup":
        rows[0] = 3
    queries = feats[rows].copy()
    if mod == "zero":
        queries[0] = 0.0                       # zero query: all scores 0
    if mod == "anti":
        queries = -queries
    excl = rows.astype(np.int32) if exclude else np.full(b, -1, np.int32)
    retriever = Retriever(make_catalog(feats), RetrievalConfig())
    s, i = retriever.retrieve(queries, k=k, exclude_rows=excl)
    check(s, i, *reference(queries, feats, excl, k))
