"""Row-sharded embedding tables with cross-device lookup.

The reference has no embeddings (hand-crafted features only, SURVEY.md §2);
this implements the BASELINE config-4 scope: item/user embedding tables too
large for one chip's HBM are row-sharded over the mesh's "catalog" axis and
looked up with an on-device collective exchange.

Exchange strategy: every shard gathers the requested rows it owns (ids are
replicated; ownership = contiguous row ranges) and contributes zeros for
the rest; a `psum` over the axis assembles the full (B, D) result.  For
B·D lookup tensors this moves the same bytes as an all-to-all on a ring
but compiles to XLA's fastest reduction collective and needs no ragged
bookkeeping — the collective-based substitute for parameter-server style
gather (SURVEY.md §5 "distributed communication backend").

The custom-VJP scatter-add ensures gradients flow back only to the owning
shard's rows (standard embedding-gradient exchange: psum of dense grads
followed by local slice — correct because the forward is linear in the
table).
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spotify_recommender_tpu.core.logging import get_logger

log = get_logger(__name__)


def local_lookup(
    table_shard: jnp.ndarray,  # (rows_per_shard, D) this shard's rows
    ids: jnp.ndarray,          # (...,) global row ids, replicated
    axis_name: str,
) -> jnp.ndarray:
    """shard_map body: masked local gather + psum assembly (differentiable;
    the psum's transpose routes gradients back to the owning shard).

    `ids` may have any leading shape (batches, padded-ragged neighbor
    lists, ...); the result is ids.shape + (D,).  Out-of-range ids
    (including padded-tail rows) contribute zeros — callers that need
    strict validation use ShardedEmbeddingTable.lookup.
    """
    rows = table_shard.shape[0]
    shard = jax.lax.axis_index(axis_name)
    offset = shard * rows
    local_ids = ids.astype(jnp.int32) - offset
    mine = (local_ids >= 0) & (local_ids < rows)
    safe_ids = jnp.clip(local_ids, 0, rows - 1)
    gathered = table_shard[safe_ids]                       # (..., D)
    contrib = jnp.where(mine[..., None], gathered, 0.0)
    return jax.lax.psum(contrib, axis_name)


def sharded_ids_lookup(
    table_shard: jnp.ndarray,  # (rows_per_shard, D) this shard's rows
    ids_shard: jnp.ndarray,    # (n_local, ...) this shard's slice of ids
    axis_name: str,
) -> jnp.ndarray:
    """shard_map body for lookups whose ids are row-sharded over the SAME
    axis as the table (e.g. sharded-table ALS: each device solves its user
    shard and needs item rows owned by every shard).

    Exchange = all_gather(ids) [cheap: int32] → masked local gather →
    **psum_scatter** back to the owner — the reduce-scatter form of the
    embedding all-to-all, as one XLA collective.  Returns
    embeddings for the local id shard: ids_shard.shape + (D,).
    """
    rows = table_shard.shape[0]
    shard = jax.lax.axis_index(axis_name)
    offset = shard * rows
    ids_all = jax.lax.all_gather(ids_shard, axis_name, tiled=True)
    local = ids_all.astype(jnp.int32) - offset
    mine = (local >= 0) & (local < rows)
    gathered = table_shard[jnp.clip(local, 0, rows - 1)]
    contrib = jnp.where(mine[..., None], gathered, 0.0)
    return jax.lax.psum_scatter(
        contrib, axis_name, scatter_dimension=0, tiled=True
    )


class ShardedEmbeddingTable:
    """A (V, D) table row-sharded over `axis_name`; lookups take replicated
    id batches and return replicated (B, D) embeddings."""

    def __init__(
        self,
        table: np.ndarray,
        mesh: Mesh,
        axis_name: str = "catalog",
    ) -> None:
        self.mesh = mesh
        self.axis_name = axis_name
        self.vocab, self.dim = table.shape
        n_shards = mesh.shape[axis_name]
        pad = (-self.vocab) % n_shards
        if pad:
            table = np.concatenate(
                [table, np.zeros((pad, self.dim), table.dtype)], axis=0
            )
        self.padded_vocab = table.shape[0]
        self.table = jax.device_put(
            jnp.asarray(table),
            NamedSharding(mesh, P(axis_name, None)),
        )
        self._lookup = jax.jit(
            jax.shard_map(
                partial(local_lookup, axis_name=axis_name),
                mesh=mesh,
                in_specs=(P(axis_name, None), P()),
                out_specs=P(),
                check_vma=False,
            )
        )
        log.info(
            "sharded embedding table: %dx%d over %d shards",
            self.vocab, self.dim, n_shards,
        )

    def lookup(self, ids: jnp.ndarray, validate: bool = True) -> jnp.ndarray:
        """Gather rows for global `ids`.

        With `validate` (default), ids are range-checked host-side against
        the true vocab — out-of-range ids (including the zero-padded tail
        rows) would otherwise silently return zero vectors and mask caller
        indexing bugs.  Pass validate=False inside traced code.
        """
        ids = jnp.asarray(ids, jnp.int32)
        if validate and not isinstance(ids, jax.core.Tracer):
            bad_lo = int(jnp.min(ids)) < 0
            bad_hi = int(jnp.max(ids)) >= self.vocab
            if bad_lo or bad_hi:
                raise IndexError(
                    f"embedding ids out of range [0, {self.vocab}): "
                    f"min={int(jnp.min(ids))} max={int(jnp.max(ids))}"
                )
        return self._lookup(self.table, ids)
