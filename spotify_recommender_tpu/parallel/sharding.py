"""Sharded-catalog retrieval: row-shard the item matrix over the mesh.

The reference is strictly single-device (`cudaSetDevice(0)`, reference
Recommender.cu:124) with no communication backend (SURVEY.md §2).  The
scale-out plan (SURVEY.md §7 step 3):

- the catalog's N axis is sharded over mesh axis "catalog" (this workload's
  natural tensor parallelism) with `NamedSharding`;
- each device scores its rows and selects a **local** top-k with local→global
  index translation — only (k scores + k indices) per query per shard
  cross the interconnect, never the (B, N) score matrix;
- an `all_gather` over "catalog" collects the per-shard candidates and a
  final deterministic merge selects the global top-k, tie-breaking by global
  index so results are invariant to the shard layout;
- queries are replicated over "catalog" and (optionally) sharded over
  "data" for query-batch data parallelism.

Padding rows (to equalize shard sizes) carry -inf scores so they can never
enter a top-k.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spotify_recommender_tpu.core.config import COSINE_EPS
from spotify_recommender_tpu.core.logging import get_logger
from spotify_recommender_tpu.ops.topk import merge_topk_deterministic
from spotify_recommender_tpu.retrieval.path import (
    KERNEL,
    choose_path,
    score_topk,
)

log = get_logger(__name__)


def _pad_to_multiple(x: np.ndarray, multiple: int) -> np.ndarray:
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    pad_block = np.zeros((pad,) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, pad_block], axis=0)


def _local_topk(
    queries: jnp.ndarray,       # (B, F) replicated
    features: jnp.ndarray,      # (N_local, F) this shard's rows
    norms: jnp.ndarray,         # (N_local,)
    exclude_rows: jnp.ndarray,  # (B,) global row ids, -1 = none
    valid_rows: jnp.ndarray,    # () int32: global N (pad rows >= this)
    *,
    k: int,
    eps: float,
    path: str,
    interpret: bool,
    axis_name: str,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-shard body run under shard_map: the shard's top-k on the chosen
    path (retrieval/path.py), in global row ids, then the all_gather of
    (B, k) candidates and the deterministic merge."""
    shard = jax.lax.axis_index(axis_name)
    n_local = features.shape[0]
    offset = (shard * n_local).astype(jnp.int32)
    excl = exclude_rows.astype(jnp.int32)
    # global exclusions and valid count, in this shard's frame
    excl_local = jnp.where(
        (excl >= offset) & (excl < offset + n_local), excl - offset, -1
    )
    valid_local = jnp.clip(valid_rows - offset, 0, n_local).astype(jnp.int32)
    local_s, local_i = score_topk(
        queries, features, norms, excl_local, valid_local,
        k=k, eps=eps, path=path, interpret=interpret,
    )
    local_i = jnp.where(local_i < 0, -1, offset + local_i)
    cand_s = jax.lax.all_gather(local_s, axis_name, axis=1, tiled=True)
    cand_i = jax.lax.all_gather(local_i, axis_name, axis=1, tiled=True)
    return merge_topk_deterministic(cand_s, cand_i, k)


@partial(
    jax.jit,
    static_argnames=(
        "k", "eps", "mesh", "axis_name", "data_axis", "path", "interpret",
    ),
)
def sharded_topk_retrieve(
    queries: jnp.ndarray,
    features: jnp.ndarray,
    norms: jnp.ndarray,
    exclude_rows: jnp.ndarray,
    valid_rows: jnp.ndarray,
    *,
    k: int,
    mesh: Mesh,
    axis_name: str = "catalog",
    eps: float = COSINE_EPS,
    data_axis: Optional[str] = None,
    path: str = "xla",
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Row-sharded exact top-k over the mesh (see module docstring).

    With `data_axis`, the query batch is additionally sharded over that
    mesh axis (2-D data x catalog parallelism): each data group runs the
    same catalog-sharded retrieval on its batch slice, with no
    cross-group communication."""
    body = partial(
        _local_topk, k=k, eps=eps, path=path, interpret=interpret,
        axis_name=axis_name,
    )
    qspec = P(data_axis, None) if data_axis else P()
    espec = P(data_axis) if data_axis else P()
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            qspec,               # queries: replicated, or data-sharded
            P(axis_name, None),  # features row-sharded
            P(axis_name),        # norms row-sharded
            espec,               # exclude follows the query sharding
            P(),                 # valid_rows replicated
        ),
        out_specs=(qspec, qspec),
        check_vma=False,
    )
    return fn(queries, features, norms, exclude_rows, valid_rows)


class ShardedCatalog:
    """Device-resident, row-sharded catalog features + norms.

    Each shard runs the path that retrieval/path.choose_path picks for its
    own (N_local, F, B_local, k); `interpret=True` (tests only) runs the
    Triton kernel per shard in interpret mode instead.
    """

    def __init__(
        self,
        features: np.ndarray,
        norms: np.ndarray,
        mesh: Mesh,
        axis_name: str = "catalog",
        eps: float = COSINE_EPS,
        use_kernel: bool = True,
        interpret: bool = False,
        data_axis: Optional[str] = None,
    ) -> None:
        n_shards = mesh.shape[axis_name]
        feats = _pad_to_multiple(np.asarray(features, np.float32), n_shards)
        nrm = _pad_to_multiple(np.asarray(norms, np.float32), n_shards)
        self._setup(
            mesh, axis_name, data_axis, eps, use_kernel, interpret,
            num_items=features.shape[0],
            features=jax.device_put(
                feats, NamedSharding(mesh, P(axis_name, None))
            ),
            norms=jax.device_put(nrm, NamedSharding(mesh, P(axis_name))),
        )

    @classmethod
    def from_artifact(
        cls,
        artifact,
        mesh: Mesh,
        axis_name: str = "catalog",
        data_axis: Optional[str] = None,
        eps: float = COSINE_EPS,
        use_kernel: bool = True,
        interpret: bool = False,
    ) -> "ShardedCatalog":
        """Sharded retrieval straight from an OCDBT artifact
        (data/sharded_catalog.load_sharded_catalog): its mesh-sharded
        arrays are served as they were restored, so the full feature
        matrix is never materialized on any single host.  This is the
        multi-host path past the reference's single-GPU memory wall
        (reference ARCHITECTURE.md:305-309)."""
        n_shards = mesh.shape[axis_name]
        rows = artifact.features.shape[0]
        if rows % n_shards:
            raise ValueError(
                f"artifact rows {rows} not divisible by mesh axis "
                f"{axis_name}={n_shards}"
            )
        self = cls.__new__(cls)
        self._setup(
            mesh, axis_name, data_axis, eps, use_kernel, interpret,
            num_items=artifact.num_items,
            features=artifact.features,
            norms=artifact.norms,
        )
        return self

    def _setup(self, mesh, axis_name, data_axis, eps, use_kernel, interpret,
               *, num_items, features, norms) -> None:
        self.mesh = mesh
        self.axis_name = axis_name
        # 2-D data x catalog parallelism: with `data_axis` set (and the
        # mesh carrying that axis), the query batch is sharded over it —
        # each data group scores its slice against the full (catalog-
        # sharded) item matrix, so the allgather+merge runs independently
        # per group and batch must divide the data-axis size
        self.data_axis = data_axis if (
            data_axis is not None and mesh.shape.get(data_axis, 1) > 1
        ) else None
        self.eps = eps
        self.use_kernel = use_kernel
        self.interpret = interpret
        self.num_items = num_items
        self.features = features
        self.norms = norms
        self.n_local = features.shape[0] // mesh.shape[axis_name]
        self._valid = jnp.asarray(num_items, jnp.int32)
        log.info(
            "sharded catalog: %d items over %d '%s' shards (%d rows each)",
            num_items, mesh.shape[axis_name], axis_name, self.n_local,
        )

    def path_for(self, b: int, k: int) -> str:
        """The path each shard runs for a (b, k) call."""
        if self.interpret:
            return KERNEL
        n_data = self.mesh.shape[self.data_axis] if self.data_axis else 1
        return choose_path(
            self.mesh.devices.flat[0].platform, self.n_local,
            self.features.shape[1], max(1, b // n_data), k,
            use_kernel=self.use_kernel,
        )

    def retrieve(
        self,
        queries: jnp.ndarray,
        k: int,
        exclude_rows: Optional[jnp.ndarray] = None,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
        b = queries.shape[0]
        if exclude_rows is None:
            exclude_rows = jnp.full((b,), -1, jnp.int32)
        n_data = self.mesh.shape[self.data_axis] if self.data_axis else 1
        if b % n_data:
            raise ValueError(
                f"batch {b} must divide the '{self.data_axis}' axis "
                f"size {n_data}"
            )
        return sharded_topk_retrieve(
            queries,
            self.features,
            self.norms,
            jnp.asarray(exclude_rows, jnp.int32),
            self._valid,
            k=k,
            mesh=self.mesh,
            axis_name=self.axis_name,
            eps=self.eps,
            data_axis=self.data_axis,
            path=self.path_for(b, k),
            interpret=self.interpret,
        )
