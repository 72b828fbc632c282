"""Top-k merge primitives for blockwise and sharded retrieval.

The reference selects top-N with a host-side min-heap over the full
similarity vector (reference Recommender.cu:293-315).  Here the catalog is
processed in chunks, kernel segments and/or shards (mesh axis "catalog"),
so top-k becomes: per-part partial top-k → merge.  Merging two top-k lists
is itself a top-k over their concatenation, which keeps `lax.top_k`'s
lowest-index-wins tie rule end-to-end, so results are invariant to tiling
and sharding layout (the determinism requirement of SURVEY.md §7 step 3).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def merge_topk(
    scores_a: jnp.ndarray,
    idx_a: jnp.ndarray,
    scores_b: jnp.ndarray,
    idx_b: jnp.ndarray,
    k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge two partial top-k lists (B, ka) + (B, kb) → (B, k).

    Ties break toward list order then index order; callers must pass
    candidates ordered by ascending global index for layout-invariant
    results (the sharded merge in parallel/sharding.py does).
    """
    scores = jnp.concatenate([scores_a, scores_b], axis=-1)
    idx = jnp.concatenate([idx_a, idx_b], axis=-1)
    top_scores, pos = jax.lax.top_k(scores, k)
    return top_scores, jnp.take_along_axis(idx, pos, axis=-1)


def merge_topk_deterministic(
    scores: jnp.ndarray,
    idx: jnp.ndarray,
    k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k over (B, C) candidates with *global-index* tie-breaking.

    Sorts by (-score, idx) lexicographically, so equal scores prefer the
    smaller global index whatever the candidate layout (shard order,
    kernel segments) and whatever tie order the backend's `lax.top_k`
    keeps.  Adding 0.0 first folds -0.0 into +0.0, so the two zeros tie.
    """
    neg, idx_sorted = jax.lax.sort(
        (-(scores + 0.0), idx), dimension=-1, num_keys=2
    )
    return -neg[..., :k], idx_sorted[..., :k]
