"""Cosine-similarity scoring: the jnp reference oracle.

Re-states the reference's similarity math (identical on its GPU and CPU
paths) as pure JAX:

- dot products: one GEMV/GEMM at `Precision.HIGHEST` (replaces cuBLAS
  SGEMV, reference Recommender.cu:217-223; HIGHEST keeps an H100 off TF32);
- cosine normalization with the 1e-8 zero-denominator guard and [-1, 1]
  clamp (reference Recommender.cu:62-77 GPU, :256-273 CPU);
- top-k stays **on device** via `lax.top_k` — the reference copied the full
  N-float similarity vector back to host and ran a min-heap there
  (reference Recommender.cu:248-249, :293-315); we transfer only k
  (index, score) pairs;
- self-exclusion by masking the query row to -inf before top-k
  (reference skips the query index during heap fill, Recommender.cu:296).

This module is the *oracle*: simple, obviously-correct XLA code that the
fused Triton kernel (ops/pallas/fused_topk.py) is validated against, and
the XLA retrieval paths of retrieval/path.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from spotify_recommender_tpu.core.config import COSINE_EPS
from spotify_recommender_tpu.ops.topk import merge_topk

# numpy (not jnp) scalar: a module-level jnp constant would initialize
# the XLA backend at import time, which breaks jax.distributed.initialize
# in multi-host processes (must run before ANY backend use)
import numpy as _np  # noqa: E402  (scoped import for this constant)

NEG_INF = _np.float32(-_np.inf)


def cosine_scores(
    query: jnp.ndarray,
    features: jnp.ndarray,
    norms: Optional[jnp.ndarray] = None,
    eps: float = COSINE_EPS,
) -> jnp.ndarray:
    """Cosine similarity of one query (F,) against the catalog (N, F).

    Exact reference semantics (Recommender.cu:262-272): score_i =
    clamp(dot_i / (norm_i * q_norm), -1, 1) when the denominator > eps,
    else 0.
    """
    return cosine_scores_batched(query[None, :], features, norms, eps)[0]


def cosine_scores_batched(
    queries: jnp.ndarray,
    features: jnp.ndarray,
    norms: Optional[jnp.ndarray] = None,
    eps: float = COSINE_EPS,
) -> jnp.ndarray:
    """Cosine similarity of a query batch (B, F) against the catalog (N, F).

    One (B, F) x (F, N) GEMM — the batched generalization of the
    reference's per-query SGEMV.
    """
    queries = jnp.asarray(queries, jnp.float32)
    features = jnp.asarray(features, jnp.float32)
    if norms is None:
        norms = jnp.linalg.norm(features, axis=1)
    q_norms = jnp.linalg.norm(queries, axis=1)
    # HIGHEST pins true-fp32 products: the default lets an H100 run fp32
    # matmuls in TF32, which breaks score parity with the reference's SGEMV
    # (~1e-3 error).
    dots = jnp.dot(
        queries,
        features.T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    denom = q_norms[:, None] * norms[None, :]
    scores = jnp.where(
        denom > jnp.float32(eps),
        jnp.clip(dots / denom, -1.0, 1.0),
        jnp.float32(0.0),
    )
    return scores


def _mask_self(scores: jnp.ndarray, exclude_rows: jnp.ndarray) -> jnp.ndarray:
    """Mask scores[b, exclude_rows[b]] to -inf; -1 disables exclusion."""
    n = scores.shape[1]
    cols = jnp.arange(n, dtype=jnp.int32)[None, :]
    excl = exclude_rows.astype(jnp.int32)[:, None]
    return jnp.where(cols == excl, NEG_INF, scores)


def topk_scores(
    scores: jnp.ndarray,
    k: int,
    exclude_rows: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k over a (B, N) score matrix with optional per-row self-exclusion.

    Ties break toward the lower catalog index (lax.top_k semantics), the
    deterministic pinning of the reference heap's boundary behavior
    (reference Recommender.cu:300-305 keeps first-seen = lowest index on
    strict-greater replacement).
    """
    if exclude_rows is not None:
        scores = _mask_self(scores, exclude_rows)
    return jax.lax.top_k(scores, k)


@partial(jax.jit, static_argnames=("k", "eps", "chunk"))
def exact_topk_chunked(
    queries: jnp.ndarray,
    features: jnp.ndarray,
    norms: Optional[jnp.ndarray] = None,
    exclude_rows: Optional[jnp.ndarray] = None,
    k: int = 10,
    eps: float = COSINE_EPS,
    chunk: int = 131072,
    num_valid: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact retrieval as a `lax.scan` over catalog chunks.

    Peak memory is O(B x chunk) instead of O(B x N) — the XLA fallback for
    catalogs where the full score matrix would not fit (at B=1k, N=10M the
    naive path wants 40 GB).  Results are identical to `exact_topk`:
    per-chunk top-k + merge preserves the lowest-index tie rule because
    chunks are processed in ascending index order and `merge_topk` favors
    the earlier list.  Rows >= `num_valid` (default N) score -inf.
    """
    queries = jnp.asarray(queries, jnp.float32)
    features = jnp.asarray(features, jnp.float32)
    if norms is None:
        norms = jnp.linalg.norm(features, axis=1)
    n = features.shape[0]
    b = queries.shape[0]
    limit = n if num_valid is None else jnp.minimum(num_valid, n)
    chunk = min(chunk, max(k, n))
    nchunks = -(-n // chunk)
    npad = nchunks * chunk
    feats_p = jnp.pad(features, ((0, npad - n), (0, 0)))
    norms_p = jnp.pad(norms, (0, npad - n))
    feats_c = feats_p.reshape(nchunks, chunk, -1)
    norms_c = norms_p.reshape(nchunks, chunk)
    offsets = jnp.arange(nchunks, dtype=jnp.int32) * chunk
    excl = (
        jnp.full((b,), -1, jnp.int32)
        if exclude_rows is None
        else exclude_rows.astype(jnp.int32)
    )

    def body(carry, xs):
        best_s, best_i = carry
        fch, nch, off = xs
        scores = cosine_scores_batched(queries, fch, nch, eps)
        gcols = off + jnp.arange(chunk, dtype=jnp.int32)
        bad = (gcols[None, :] >= limit) | (gcols[None, :] == excl[:, None])
        scores = jnp.where(bad, NEG_INF, scores)
        ch_s, ch_pos = jax.lax.top_k(scores, k)
        best_s, best_i = merge_topk(
            best_s, best_i, ch_s, off + ch_pos.astype(jnp.int32), k
        )
        return (best_s, best_i), None

    init = (
        jnp.full((b, k), NEG_INF, jnp.float32),
        jnp.full((b, k), -1, jnp.int32),
    )
    (best_s, best_i), _ = jax.lax.scan(
        body, init, (feats_c, norms_c, offsets)
    )
    return best_s, best_i


@partial(jax.jit, static_argnames=("k", "chunk"))
def mips_topk_chunked(
    queries: jnp.ndarray,            # (B, D) fp32 query embeddings
    items: jnp.ndarray,              # (N, D) fp32 item embeddings
    seen_idx: Optional[jnp.ndarray] = None,   # (B, S) int32 rows to exclude
    seen_mask: Optional[jnp.ndarray] = None,  # (B, S) bool valid-entry mask
    k: int = 10,
    chunk: int = 131072,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact maximum-inner-product top-k as a `lax.scan` over item chunks.

    The MF/two-tower serving primitive (BASELINE config 3/5): raw dot
    scores (no cosine epilogue), optional per-query *set* exclusion
    (padded-ragged `seen_idx`/`seen_mask` — e.g. each user's training
    positives), O(B x chunk) peak memory.  Ties break toward the lower
    item index (chunks ascend; `merge_topk` favors the earlier list).
    """
    queries = jnp.asarray(queries, jnp.float32)
    items = jnp.asarray(items, jnp.float32)
    n, b = items.shape[0], queries.shape[0]
    chunk = min(chunk, max(k, n))
    nchunks = -(-n // chunk)
    npad = nchunks * chunk
    items_c = jnp.pad(items, ((0, npad - n), (0, 0))).reshape(
        nchunks, chunk, -1
    )
    offsets = jnp.arange(nchunks, dtype=jnp.int32) * chunk
    rows = jnp.arange(b, dtype=jnp.int32)[:, None]

    def body(carry, xs):
        best_s, best_i = carry
        ich, off = xs
        scores = jnp.dot(
            queries, ich.T,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )                                                   # (B, chunk)
        gcols = off + jnp.arange(chunk, dtype=jnp.int32)
        scores = jnp.where(gcols[None, :] >= n, NEG_INF, scores)
        if seen_idx is not None:
            local = seen_idx.astype(jnp.int32) - off        # (B, S)
            in_chunk = (local >= 0) & (local < chunk)
            if seen_mask is not None:
                in_chunk = in_chunk & seen_mask
            # scatter-min: -inf where the seen entry lands in this chunk,
            # +inf (no-op) elsewhere; padded entries collide harmlessly at 0
            upd = jnp.where(in_chunk, NEG_INF, jnp.float32(jnp.inf))
            scores = scores.at[rows, jnp.clip(local, 0, chunk - 1)].min(upd)
        ch_s, ch_pos = jax.lax.top_k(scores, k)
        best_s, best_i = merge_topk(
            best_s, best_i, ch_s, off + ch_pos.astype(jnp.int32), k
        )
        return (best_s, best_i), None

    init = (
        jnp.full((b, k), NEG_INF, jnp.float32),
        jnp.full((b, k), -1, jnp.int32),
    )
    (best_s, best_i), _ = jax.lax.scan(body, init, (items_c, offsets))
    return best_s, best_i


@partial(jax.jit, static_argnames=("k", "eps"))
def exact_topk(
    queries: jnp.ndarray,
    features: jnp.ndarray,
    norms: Optional[jnp.ndarray] = None,
    exclude_rows: Optional[jnp.ndarray] = None,
    k: int = 10,
    eps: float = COSINE_EPS,
    num_valid: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused-by-XLA exact retrieval: scores + top-k in one jit program.

    Returns (top_scores (B, k), top_indices (B, k)).  Rows >= `num_valid`
    (default N) score -inf.
    """
    scores = cosine_scores_batched(queries, features, norms, eps)
    if num_valid is not None:
        cols = jnp.arange(scores.shape[1], dtype=jnp.int32)[None, :]
        scores = jnp.where(cols >= num_valid, NEG_INF, scores)
    return topk_scores(scores, k, exclude_rows)
