"""Scoring parity: jnp oracle vs the reference CPU formula
(reference Recommender.cu:256-318)."""

import numpy as np
import jax.numpy as jnp

from spotify_recommender_tpu.ops.similarity import (
    cosine_scores,
    cosine_scores_batched,
    exact_topk,
    topk_scores,
)
from spotify_recommender_tpu.ops.topk import merge_topk, merge_topk_deterministic

from conftest import reference_cpu_similarities, reference_topk


def random_features(n, d=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, d)).astype(np.float32)


class TestCosineScores:
    def test_matches_reference_formula(self):
        feats = random_features(500)
        q = feats[7]
        ours = np.asarray(cosine_scores(jnp.asarray(q), jnp.asarray(feats)))
        ref = reference_cpu_similarities(q, feats)
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)

    def test_self_similarity_is_one(self):
        feats = random_features(100)
        s = np.asarray(cosine_scores(jnp.asarray(feats[3]), jnp.asarray(feats)))
        np.testing.assert_allclose(s[3], 1.0, atol=1e-6)

    def test_zero_norm_guard(self):
        # denominator <= 1e-8 -> 0 (reference Recommender.cu:67-72)
        feats = np.ones((4, 12), np.float32)
        feats[2] = 0.0
        s = np.asarray(cosine_scores(jnp.asarray(feats[0]), jnp.asarray(feats)))
        assert s[2] == 0.0
        zero_q = np.zeros(12, np.float32)
        s = np.asarray(cosine_scores(jnp.asarray(zero_q), jnp.asarray(feats)))
        np.testing.assert_array_equal(s, np.zeros(4, np.float32))

    def test_clamped(self):
        feats = random_features(50)
        s = np.asarray(cosine_scores(jnp.asarray(feats[0] * 1e6), jnp.asarray(feats)))
        assert s.max() <= 1.0 and s.min() >= -1.0

    def test_batched_matches_single(self):
        feats = random_features(300)
        qs = feats[:8]
        batched = np.asarray(cosine_scores_batched(jnp.asarray(qs), jnp.asarray(feats)))
        for i in range(8):
            single = np.asarray(cosine_scores(jnp.asarray(qs[i]), jnp.asarray(feats)))
            np.testing.assert_allclose(batched[i], single, rtol=1e-6)


class TestTopK:
    def test_exact_topk_matches_reference_selection(self):
        feats = random_features(2000, seed=3)
        for qi in [0, 17, 1999]:
            scores, rows = exact_topk(
                jnp.asarray(feats[qi][None, :]),
                jnp.asarray(feats),
                exclude_rows=jnp.asarray([qi], jnp.int32),
                k=10,
            )
            sims = reference_cpu_similarities(feats[qi], feats)
            expected = reference_topk(sims, qi, 10)
            assert list(np.asarray(rows)[0]) == expected

    def test_descending_order(self):
        feats = random_features(500, seed=5)
        scores, rows = exact_topk(
            jnp.asarray(feats[:4]), jnp.asarray(feats), k=20
        )
        s = np.asarray(scores)
        assert (np.diff(s, axis=1) <= 1e-7).all()

    def test_self_exclusion(self):
        feats = random_features(100, seed=6)
        _, rows = exact_topk(
            jnp.asarray(feats[:10]),
            jnp.asarray(feats),
            exclude_rows=jnp.arange(10, dtype=jnp.int32),
            k=5,
        )
        rows = np.asarray(rows)
        for b in range(10):
            assert b not in rows[b]

    def test_no_exclusion_returns_self_first(self):
        feats = random_features(100, seed=7)
        _, rows = exact_topk(jnp.asarray(feats[:5]), jnp.asarray(feats), k=1)
        np.testing.assert_array_equal(np.asarray(rows)[:, 0], np.arange(5))

    def test_tie_break_lowest_index(self):
        feats = np.ones((8, 12), np.float32)  # all identical -> all ties
        scores, rows = topk_scores(
            cosine_scores_batched(jnp.asarray(feats[:1]), jnp.asarray(feats)), 3
        )
        assert list(np.asarray(rows)[0]) == [0, 1, 2]


class TestMergeTopK:
    def test_merge_equals_global(self):
        rng = np.random.default_rng(8)
        scores = rng.random((4, 64)).astype(np.float32)
        idx = np.tile(np.arange(64, dtype=np.int32), (4, 1))
        gs, gi = topk_scores(jnp.asarray(scores), 10)
        a_s, a_i = topk_scores(jnp.asarray(scores[:, :32]), 10)
        b = scores[:, 32:]
        b_s, b_i = topk_scores(jnp.asarray(b), 10)
        ms, mi = merge_topk(a_s, a_i, b_s, jnp.asarray(np.asarray(b_i) + 32), 10)
        np.testing.assert_allclose(np.asarray(ms), np.asarray(gs), rtol=1e-7)
        np.testing.assert_array_equal(np.asarray(mi), np.asarray(gi))

    def test_deterministic_merge_ties(self):
        scores = np.asarray([[0.5, 0.5, 0.5, 0.5]], np.float32)
        idx = np.asarray([[7, 3, 9, 1]], np.int32)
        ms, mi = merge_topk_deterministic(jnp.asarray(scores), jnp.asarray(idx), 2)
        assert list(np.asarray(mi)[0]) == [1, 3]


class TestChunkedTopK:
    def test_matches_unchunked(self):
        from spotify_recommender_tpu.ops.similarity import exact_topk_chunked

        feats = random_features(5000, seed=21)
        q = jnp.asarray(feats[:8])
        excl = jnp.arange(8, dtype=jnp.int32)
        g_s, g_i = exact_topk(q, jnp.asarray(feats), exclude_rows=excl, k=10)
        c_s, c_i = exact_topk_chunked(
            q, jnp.asarray(feats), exclude_rows=excl, k=10, chunk=512
        )
        np.testing.assert_array_equal(np.asarray(c_i), np.asarray(g_i))
        np.testing.assert_allclose(
            np.asarray(c_s), np.asarray(g_s), rtol=1e-6, atol=1e-7
        )

    def test_unaligned_last_chunk(self):
        from spotify_recommender_tpu.ops.similarity import exact_topk_chunked

        feats = random_features(1003, seed=22)
        q = jnp.asarray(feats[:4])
        g_s, g_i = exact_topk(q, jnp.asarray(feats), k=17)
        c_s, c_i = exact_topk_chunked(q, jnp.asarray(feats), k=17, chunk=256)
        np.testing.assert_array_equal(np.asarray(c_i), np.asarray(g_i))
        assert np.asarray(c_i).max() < 1003


class TestMIPSChunked:
    """mips_topk_chunked: the MF/two-tower serving primitive."""

    def test_matches_dense_mips(self, rng):
        import jax
        import jax.numpy as jnp

        from spotify_recommender_tpu.ops.similarity import mips_topk_chunked

        items = rng.standard_normal((3000, 16)).astype(np.float32)
        q = rng.standard_normal((8, 16)).astype(np.float32)
        s, i = mips_topk_chunked(
            jnp.asarray(q), jnp.asarray(items), k=7, chunk=512
        )
        dense = q @ items.T
        ref = np.argsort(-dense, axis=1, kind="stable")[:, :7]
        np.testing.assert_array_equal(np.asarray(i), ref)

    def test_seen_set_exclusion(self, rng):
        import jax.numpy as jnp

        from spotify_recommender_tpu.ops.similarity import mips_topk_chunked

        items = rng.standard_normal((1000, 8)).astype(np.float32)
        q = items[:4]  # each query's own row scores highest
        seen_idx = np.zeros((4, 3), np.int32)
        seen_idx[:, 0] = np.arange(4)          # exclude the self row
        seen_idx[:, 1] = 999                   # plus a shared row
        seen_mask = np.ones((4, 3), bool)
        seen_mask[:, 2] = False                # padding entry ignored
        s, i = mips_topk_chunked(
            jnp.asarray(q), jnp.asarray(items),
            jnp.asarray(seen_idx), jnp.asarray(seen_mask),
            k=5, chunk=256,
        )
        i = np.asarray(i)
        for b in range(4):
            assert b not in i[b]
            assert 999 not in i[b]
        # padded (masked-off) entry 0 must NOT be excluded for rows 1..3
        dense = q @ items.T
        dense[np.arange(4), np.arange(4)] = -np.inf
        dense[:, 999] = -np.inf
        ref = np.argsort(-dense, axis=1, kind="stable")[:, :5]
        np.testing.assert_array_equal(i, ref)
