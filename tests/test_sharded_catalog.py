"""Sharded OCDBT catalog artifact: save/load round-trip on the virtual
mesh (SURVEY.md §5 checkpoint/resume at multi-host scale — the rung past
the single-host npz/dir formats)."""

import numpy as np
import pytest

from spotify_recommender_tpu.core.config import MeshConfig
from spotify_recommender_tpu.core.mesh import make_mesh
from spotify_recommender_tpu.data.catalog import Catalog
from spotify_recommender_tpu.data.sharded_catalog import (
    load_sharded_catalog,
    save_sharded_catalog,
)


@pytest.fixture(scope="module")
def catalog():
    rng = np.random.default_rng(3)
    n = 700
    feats = rng.random((n, 12), dtype=np.float32)
    return Catalog(
        features=feats,
        norms=np.linalg.norm(feats, axis=1).astype(np.float32),
        track_ids=np.asarray([f"tid{i:05d}" for i in range(n)], object),
        track_names=np.asarray([f"Song {i}" for i in range(n)], object),
        artists=np.asarray([f"Artist {i % 7}" for i in range(n)], object),
        genre_ids=(np.arange(n) % 5).astype(np.int32),
        genre_names=[f"g{j}" for j in range(5)],
        min_vals=np.zeros(11, np.float32),
        max_vals=np.ones(11, np.float32),
    )


class TestRoundTrip:
    def test_mesh_restore_is_row_sharded(self, catalog, tmp_path):
        path = str(tmp_path / "cat_ocdbt")
        save_sharded_catalog(catalog, path, shard_multiple=1024)
        mesh = make_mesh(MeshConfig(data=1, catalog=8))
        art = load_sharded_catalog(path, mesh)
        assert len(art) == len(catalog)
        assert art.features.shape == (1024, 12)     # padded global shape
        # row-sharded over the catalog axis: 8 addressable shards of 128
        assert len(art.features.addressable_shards) == 8
        for shard in art.features.addressable_shards:
            assert shard.data.shape == (128, 12)
        np.testing.assert_array_equal(
            np.asarray(art.features)[: len(catalog)], catalog.features
        )
        np.testing.assert_array_equal(
            np.asarray(art.norms)[: len(catalog)], catalog.norms
        )
        np.testing.assert_array_equal(
            np.asarray(art.genre_ids)[: len(catalog)], catalog.genre_ids
        )
        # pad rows are zero (score 0, masked by valid counts downstream)
        assert not np.asarray(art.features)[len(catalog):].any()
        assert art.genre_names == catalog.genre_names

    def test_host_metadata_sidecar(self, catalog, tmp_path):
        path = str(tmp_path / "cat_ocdbt")
        save_sharded_catalog(catalog, path, shard_multiple=1024)
        art = load_sharded_catalog(path)
        assert list(art.host_column("track_ids")) == list(catalog.track_ids)
        assert list(art.host_column("artists")) == list(catalog.artists)
        np.testing.assert_array_equal(
            art.host_column("min_vals"), catalog.min_vals
        )

    def test_indivisible_mesh_axis_rejected(self, catalog, tmp_path):
        path = str(tmp_path / "cat_ocdbt")
        save_sharded_catalog(catalog, path, shard_multiple=700)
        mesh = make_mesh(MeshConfig(data=1, catalog=8))
        with pytest.raises(ValueError, match="not divisible"):
            load_sharded_catalog(path, mesh)

    def test_sharded_retrieval_from_artifact_matches_oracle(
        self, catalog, tmp_path
    ):
        """The restored device-sharded arrays feed the sharded retrieval
        path directly — no host round-trip, results match the oracle."""
        import jax.numpy as jnp

        from spotify_recommender_tpu.ops.similarity import exact_topk
        from spotify_recommender_tpu.parallel.sharding import (
            sharded_topk_retrieve,
        )

        path = str(tmp_path / "cat_ocdbt")
        save_sharded_catalog(catalog, path, shard_multiple=1024)
        mesh = make_mesh(MeshConfig(data=1, catalog=8))
        art = load_sharded_catalog(path, mesh)
        rng = np.random.default_rng(0)
        q = jnp.asarray(
            rng.random((4, 12), dtype=np.float32)
        )
        excl = jnp.full((4,), -1, np.int32)
        s, r = sharded_topk_retrieve(
            q, art.features, art.norms, excl,
            jnp.int32(len(art)), k=5, mesh=mesh,
        )
        es, er = exact_topk(
            q, jnp.asarray(catalog.features), jnp.asarray(catalog.norms),
            exclude_rows=excl, k=5,
        )
        np.testing.assert_array_equal(np.asarray(r), np.asarray(er))
        np.testing.assert_allclose(
            np.asarray(s), np.asarray(es), rtol=0, atol=2e-7
        )

    def test_from_artifact_matches_oracle(self, catalog, tmp_path):
        """ShardedCatalog.from_artifact serves the OCDBT restore's shards
        where they landed (no host gather), with the Triton kernel per
        shard (interpret mode) — results exactly match the oracle."""
        import jax.numpy as jnp

        from spotify_recommender_tpu.ops.similarity import exact_topk
        from spotify_recommender_tpu.parallel.sharding import ShardedCatalog

        path = str(tmp_path / "cat_ocdbt_kernel")
        save_sharded_catalog(catalog, path, shard_multiple=4096)
        mesh = make_mesh(MeshConfig(data=1, catalog=8))
        art = load_sharded_catalog(path, mesh)
        sc = ShardedCatalog.from_artifact(art, mesh, interpret=True)
        assert sc.n_local == 512 and sc.features is art.features
        rng = np.random.default_rng(1)
        rows = rng.integers(0, len(art), size=8)
        q = jnp.asarray(
            catalog.features[rows]
            + 0.01 * rng.standard_normal((8, 12)).astype(np.float32)
        )
        excl = jnp.asarray(rows.astype(np.int32))
        s, r = sc.retrieve(q, 5, exclude_rows=excl)
        es, er = exact_topk(
            q, jnp.asarray(catalog.features), jnp.asarray(catalog.norms),
            exclude_rows=excl, k=5,
        )
        np.testing.assert_array_equal(np.asarray(r), np.asarray(er))
        np.testing.assert_allclose(
            np.asarray(s), np.asarray(es), rtol=0, atol=1e-6
        )

    def test_from_artifact_serves_small_shards(self, catalog, tmp_path):
        """Any shard size the artifact divides into serves: 1024 padded
        rows over 8 shards, on the path the platform picks (XLA here)."""
        import jax.numpy as jnp

        from spotify_recommender_tpu.ops.similarity import exact_topk
        from spotify_recommender_tpu.parallel.sharding import ShardedCatalog

        path = str(tmp_path / "cat_ocdbt_small")
        save_sharded_catalog(catalog, path, shard_multiple=1024)
        mesh = make_mesh(MeshConfig(data=1, catalog=8))
        art = load_sharded_catalog(path, mesh)   # 1024/8 = 128 per shard
        sc = ShardedCatalog.from_artifact(art, mesh)
        assert sc.n_local == 128 and sc.path_for(4, 5) == "xla"
        q = jnp.asarray(catalog.features[:4])
        s, r = sc.retrieve(q, 5)
        es, er = exact_topk(
            q, jnp.asarray(catalog.features), jnp.asarray(catalog.norms), k=5
        )
        np.testing.assert_array_equal(np.asarray(r), np.asarray(er))
        assert np.asarray(r).max() < len(catalog)
