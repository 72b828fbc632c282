"""The one place that decides how an exact top-k retrieval runs.

`choose_path` looks at what a call can observe (platform, catalog rows N,
feature width F, batch B, k) and names one path.  `Retriever`, the
per-shard body of `ShardedCatalog` and the windows of `StreamingRetriever`
all ask it and run `score_topk` with the answer.  There is no fallback:
an error in the chosen path propagates to the caller.

- ``KERNEL``: the fused Triton score + top-k kernel
  (ops/pallas/fused_topk.py), on the GPU for k <= KMAX and F <= FMAX;
- ``XLA_CHUNKED``: XLA scores and selects chunk by chunk in a `lax.scan`,
  so the (B, N) score matrix never exists whole;
- ``XLA``: one XLA score matrix + `lax.top_k`, for small catalogs.

On the CPU the XLA paths are the implementation, not a fallback.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from spotify_recommender_tpu.ops import similarity
from spotify_recommender_tpu.ops.pallas.fused_topk import FMAX, KMAX, fused_topk

KERNEL = "kernel"
XLA_CHUNKED = "xla_chunked"
XLA = "xla"

# Rows beyond which XLA scores the catalog in chunks.
CHUNK_ABOVE = 262_144


def choose_path(
    platform: str, n: int, f: int, b: int, k: int, use_kernel: bool = True
) -> str:
    """Name the path for one (B, F) x (N, F) top-k call on `platform`."""
    del b  # the kernel wins at every measured batch size (PERF.md)
    if use_kernel and platform == "gpu" and k <= KMAX and f <= FMAX:
        return KERNEL
    # the chunked scan also pads the catalog when k > N
    return XLA_CHUNKED if n > CHUNK_ABOVE or k > n else XLA


@partial(jax.jit, static_argnames=("k", "eps", "path", "interpret"))
def score_topk(
    queries: jnp.ndarray,        # (B, F)
    features: jnp.ndarray,       # (N, F) row-major
    norms: jnp.ndarray,          # (N,)
    exclude_rows: jnp.ndarray,   # (B,) row to drop per query, -1 = none
    valid: jnp.ndarray,          # () rows >= valid never enter the top-k
    *,
    k: int,
    eps: float,
    path: str,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact cosine top-k on `path`: (scores (B, k), rows (B, k)).

    Slots that no valid row fills score -inf and carry row -1, whatever
    the path."""
    queries = queries.astype(jnp.float32)
    exclude_rows = exclude_rows.astype(jnp.int32)
    if path == KERNEL:
        return fused_topk(
            queries, features, norms, exclude_rows, valid,
            k=k, eps=eps, interpret=interpret,
        )
    if path == XLA_CHUNKED:
        s, i = similarity.exact_topk_chunked(
            queries, features, norms, exclude_rows, k=k, eps=eps,
            num_valid=valid,
        )
    elif path == XLA:
        s, i = similarity.exact_topk(
            queries, features, norms, exclude_rows, k=k, eps=eps,
            num_valid=valid,
        )
    else:
        raise ValueError(f"unknown retrieval path {path!r}")
    return s, jnp.where(s == similarity.NEG_INF, -1, i)
