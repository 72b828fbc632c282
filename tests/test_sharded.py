"""Sharded retrieval on the virtual 8-device CPU mesh
(the multi-chip substitute — SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spotify_recommender_tpu.core.config import MeshConfig, RetrievalConfig
from spotify_recommender_tpu.core.mesh import make_mesh
from spotify_recommender_tpu.ops.similarity import exact_topk
from spotify_recommender_tpu.parallel.sharding import ShardedCatalog


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(MeshConfig(data=1, catalog=8))


def random_features(n, d=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, d)).astype(np.float32)


class TestShardedRetrieval:
    def test_matches_single_device(self, mesh8):
        feats = random_features(1000, seed=1)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        sc = ShardedCatalog(feats, norms, mesh8)
        queries = jnp.asarray(feats[:16])
        s_scores, s_rows = sc.retrieve(queries, k=10)
        g_scores, g_rows = exact_topk(queries, jnp.asarray(feats), jnp.asarray(norms), k=10)
        np.testing.assert_allclose(
            np.asarray(s_scores), np.asarray(g_scores), rtol=1e-6, atol=1e-7
        )
        np.testing.assert_array_equal(np.asarray(s_rows), np.asarray(g_rows))

    def test_unaligned_catalog_padding(self, mesh8):
        # 1003 items: shards get padded; pad rows must never appear in top-k
        feats = random_features(1003, seed=2)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        sc = ShardedCatalog(feats, norms, mesh8)
        queries = jnp.asarray(feats[:8])
        scores, rows = sc.retrieve(queries, k=50)
        assert np.asarray(rows).max() < 1003
        g_scores, g_rows = exact_topk(queries, jnp.asarray(feats), jnp.asarray(norms), k=50)
        np.testing.assert_array_equal(np.asarray(rows), np.asarray(g_rows))

    def test_exclusion(self, mesh8):
        feats = random_features(512, seed=3)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        sc = ShardedCatalog(feats, norms, mesh8)
        excl = jnp.arange(8, dtype=jnp.int32)
        _, rows = sc.retrieve(jnp.asarray(feats[:8]), k=10, exclude_rows=excl)
        rows = np.asarray(rows)
        for b in range(8):
            assert b not in rows[b]

    def test_layout_invariance(self):
        # identical results on 2-, 4-, and 8-way sharded layouts
        feats = random_features(640, seed=4)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        queries = jnp.asarray(feats[:4])
        results = []
        for n_shards in (2, 4, 8):
            mesh = make_mesh(MeshConfig(data=1, catalog=n_shards))
            sc = ShardedCatalog(feats, norms, mesh)
            _, rows = sc.retrieve(queries, k=25)
            results.append(np.asarray(rows))
        np.testing.assert_array_equal(results[0], results[1])
        np.testing.assert_array_equal(results[1], results[2])

    def test_retriever_integration(self, mesh8):
        from spotify_recommender_tpu.data.catalog import Catalog
        from spotify_recommender_tpu.retrieval.retriever import Retriever

        feats = random_features(300, seed=5)
        n = feats.shape[0]
        cat = Catalog(
            features=feats,
            norms=None,
            track_ids=np.asarray([f"id{i}" for i in range(n)], dtype=object),
            track_names=np.asarray([f"Song {i}" for i in range(n)], dtype=object),
            artists=np.asarray(["A"] * n, dtype=object),
            genre_ids=np.zeros(n, np.int32),
            genre_names=["g"],
            min_vals=np.zeros(11, np.float32),
            max_vals=np.ones(11, np.float32),
        )
        r = Retriever(cat, RetrievalConfig(use_pallas=False), mesh=mesh8)
        recs = r.recommend_by_index(5, k=10)
        assert len(recs) == 10
        assert all(rec.row != 5 for rec in recs)

        single = Retriever(cat, RetrievalConfig(use_pallas=False))
        recs_single = single.recommend_by_index(5, k=10)
        assert [x.row for x in recs] == [x.row for x in recs_single]


class TestShardedPallas:
    """Fused Triton kernel per shard (interpret mode on the CPU mesh)."""

    def test_matches_oracle(self, mesh8):
        feats = random_features(1000, seed=31)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        sc = ShardedCatalog(feats, norms, mesh8, interpret=True)
        queries = jnp.asarray(feats[:8])
        excl = jnp.arange(8, dtype=jnp.int32)
        s_s, s_r = sc.retrieve(queries, k=10, exclude_rows=excl)
        g_s, g_r = exact_topk(
            queries, jnp.asarray(feats), jnp.asarray(norms),
            exclude_rows=excl, k=10,
        )
        np.testing.assert_array_equal(np.asarray(s_r), np.asarray(g_r))
        np.testing.assert_allclose(
            np.asarray(s_s), np.asarray(g_s), rtol=1e-6, atol=1e-7
        )

    def test_unaligned_catalog(self, mesh8):
        feats = random_features(777, seed=32)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        sc = ShardedCatalog(feats, norms, mesh8, interpret=True)
        queries = jnp.asarray(feats[:4])
        s_s, s_r = sc.retrieve(queries, k=20)
        g_s, g_r = exact_topk(queries, jnp.asarray(feats), jnp.asarray(norms), k=20)
        np.testing.assert_array_equal(np.asarray(s_r), np.asarray(g_r))
        assert np.asarray(s_r).max() < 777


class TestKernelSharded:
    """The kernel per shard on larger shards: local top-k in global row
    ids + deterministic merge must equal the oracle exactly."""

    def test_matches_oracle_sharded(self, rng):
        n = 4000 + 19
        feats = rng.random((n, 12), dtype=np.float32)
        feats[7] = feats[3]                     # an exact tie across rows
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        mesh = make_mesh(MeshConfig(data=1, catalog=8))
        sc = ShardedCatalog(feats, norms, mesh, interpret=True)
        rows = np.concatenate(
            [[3], rng.integers(0, n, 15)]
        ).astype(np.int32)
        q = feats[rows]
        s, i = sc.retrieve(jnp.asarray(q), 10, jnp.asarray(rows))
        rs, ri = exact_topk(
            jnp.asarray(q), jnp.asarray(feats), jnp.asarray(norms),
            exclude_rows=jnp.asarray(rows), k=10,
        )
        np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))
        np.testing.assert_allclose(
            np.asarray(s), np.asarray(rs), rtol=0, atol=1e-6
        )

    def test_layout_invariance(self, rng):
        n = 3000
        feats = rng.random((n, 12), dtype=np.float32)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        q = feats[:8]
        outs = []
        for shards in (2, 8):
            mesh = make_mesh(MeshConfig(data=1, catalog=shards))
            sc = ShardedCatalog(feats, norms, mesh, interpret=True)
            _, i = sc.retrieve(jnp.asarray(q), 7)
            outs.append(np.asarray(i))
        np.testing.assert_array_equal(outs[0], outs[1])


class Test2DMesh:
    """2-D data x catalog parallelism: batch sharded over 'data', catalog
    rows over 'catalog' (VERDICT r3 item 8)."""

    def test_xla_backend_matches_oracle(self):
        feats = random_features(1003, seed=7)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        mesh = make_mesh(MeshConfig(data=2, catalog=4))
        sc = ShardedCatalog(feats, norms, mesh, data_axis="data")
        q = jnp.asarray(feats[100:116])
        excl = jnp.arange(100, 116, dtype=jnp.int32)
        s, i = sc.retrieve(q, 10, excl)
        rs, ri = exact_topk(
            q, jnp.asarray(feats), jnp.asarray(norms),
            exclude_rows=excl, k=10,
        )
        np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))
        np.testing.assert_allclose(
            np.asarray(s), np.asarray(rs), rtol=0, atol=1e-6
        )

    def test_kernel_backend_matches_oracle(self):
        feats = random_features(900, seed=8)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        mesh = make_mesh(MeshConfig(data=4, catalog=2))
        sc = ShardedCatalog(
            feats, norms, mesh, data_axis="data", interpret=True,
        )
        q = jnp.asarray(feats[:8])
        s, i = sc.retrieve(q, 5)
        rs, ri = exact_topk(q, jnp.asarray(feats), jnp.asarray(norms), k=5)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))

    def test_batch_must_divide_data_axis(self):
        feats = random_features(640, seed=9)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        mesh = make_mesh(MeshConfig(data=2, catalog=4))
        sc = ShardedCatalog(feats, norms, mesh, data_axis="data")
        with pytest.raises(ValueError, match="divide"):
            sc.retrieve(jnp.asarray(feats[:7]), 5)


class TestICITraffic:
    def test_allgather_moves_only_candidates(self):
        """Every all_gather in the sharded program carries (B, k)
        payloads — the (B, N) score matrix never crosses the
        interconnect."""
        import functools

        from spotify_recommender_tpu.parallel.sharding import (
            sharded_topk_retrieve,
        )

        feats = random_features(1024, seed=10)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        mesh = make_mesh(MeshConfig(data=1, catalog=8))
        sc = ShardedCatalog(feats, norms, mesh)
        b, k = 16, 10
        q = jnp.asarray(feats[:b])
        excl = jnp.full((b,), -1, jnp.int32)
        jaxpr = jax.make_jaxpr(
            functools.partial(
                sharded_topk_retrieve, k=k, mesh=mesh, axis_name="catalog"
            )
        )(q, sc.features, sc.norms, excl, sc._valid)

        def find(jx, name, out):
            for eqn in jx.eqns:
                if eqn.primitive.name == name:
                    out.append(eqn)
                for val in eqn.params.values():
                    vals = val if isinstance(val, (tuple, list)) else (val,)
                    for v in vals:
                        sub = getattr(v, "jaxpr", v)
                        if hasattr(sub, "eqns"):
                            find(sub, name, out)
            return out

        gathers = find(jaxpr.jaxpr, "all_gather", [])
        assert gathers
        for eqn in gathers:
            payload = int(np.prod(eqn.invars[0].aval.shape))
            assert payload <= b * k


def test_dryrun_multichip_16_devices():
    """The graft dryrun passes at n_devices=16 (subprocess: the device
    count must be set before backend init)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import jax; "
        "import __graft_entry__ as g; "
        "g.dryrun_multichip(16); print('OK16')"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK16" in proc.stdout


class TestShardPathChoice:
    """Each shard runs the path retrieval/path.choose_path picks for its
    own shape; `interpret=True` (tests) forces the kernel."""

    def test_cpu_shards_run_xla(self, mesh8):
        feats = random_features(1000, seed=11)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        sc = ShardedCatalog(feats, norms, mesh8)
        assert sc.n_local == 125
        assert sc.path_for(16, 10) == "xla"
        assert ShardedCatalog(
            feats, norms, mesh8, interpret=True
        ).path_for(16, 10) == "kernel"

    def test_shards_land_on_every_device(self, mesh8):
        feats = random_features(803, seed=12)
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        sc = ShardedCatalog(feats, norms, mesh8)
        devices = {s.device for s in sc.features.addressable_shards}
        assert devices == set(mesh8.devices.flat)
        assert all(
            s.data.shape == (sc.n_local, 12)
            for s in sc.features.addressable_shards
        )
