"""Fused exact cosine score + top-k, as a Pallas kernel through Triton.

One kernel replaces the reference's SGEMV + normalize kernel + full-vector
copy + host heap (reference Recommender.cu:217-223, :62-77, :248-249,
:293-315), and keeps the (B, N) score matrix that XLA's plain version
writes out of device memory:

- **grid** = query blocks (BQ rows) x catalog segments.  Each program walks
  its segment's catalog tiles (BN rows of the row-major (N, F) catalog) in
  a loop and keeps its running top-k in registers;
- **scoring** is exact fp32: the (BQ, FP) x (FP, BN) product runs with
  IEEE fp32 inputs (FMA on the CUDA cores, never TF32), followed by the
  reference epilogue: 1e-8 denominator guard and [-1, 1] clamp.  Rows past
  the valid count and each query's excluded row score -inf;
- **selection** runs only while some query's tile maximum beats its
  current k-th score, so after the first tiles most tiles cost one row
  max.  Each round moves every query's best remaining candidate (lowest
  index among equal scores) into the slot of its worst kept one;
- **merge**: each segment's (B, k) candidates are merged by one small XLA
  sort on (-score, row), which keeps the lowest-index tie rule.

`interpret=True` runs the same kernel on the CPU (tests only).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from spotify_recommender_tpu.ops.topk import merge_topk_deterministic

# numpy (not jnp) scalars: a kernel body may not close over jnp constants
NEG_INF = np.float32(-np.inf)
POS_INF = np.float32(np.inf)
_BIG_I32 = np.int32(2**31 - 1)

# Largest k and feature width the kernel takes (the selection keeps
# next_pow2(k) slots per query row in registers).
KMAX = 64
FMAX = 128
# Programs to keep in flight: two per SM of an H100 (132 SMs).
TARGET_PROGRAMS = 264
MIN_TILES_PER_SEGMENT = 4
TILE_ELEMENTS = 4096


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Block sizes and segment count, derived from the shape alone."""

    bq: int             # query rows per program (power of two, >= 16)
    bn: int             # catalog rows per tile (power of two)
    fp: int             # feature width padded to a power of two (>= 16)
    kp: int             # top-k slots per query row (power of two >= k)
    segments: int       # catalog segments (second grid axis)
    tiles_per_segment: int


def plan(b: int, n: int, f: int, k: int) -> KernelPlan:
    """Choose block sizes, then enough catalog segments that about
    TARGET_PROGRAMS programs run at any batch size.

    The score tile is BQ x BN = 4096 fp32 (32 registers a thread at four
    warps).  Wide features take 32 query rows per tile, so each (BN, F)
    catalog load feeds twice the products; narrow ones take 16 rows and
    256-row tiles (block sizes swept on an H100, PERF.md)."""
    fp = max(16, _next_pow2(f))
    bq = 32 if (b >= 32 and fp >= 64) else 16
    bn = TILE_ELEMENTS // bq
    kp = _next_pow2(k)
    ntiles = max(1, -(-n // bn))
    qblocks = -(-b // bq)
    want = max(1, -(-TARGET_PROGRAMS // qblocks))
    segments = max(1, min(want, ntiles // MIN_TILES_PER_SEGMENT))
    tps = -(-ntiles // segments)
    segments = -(-ntiles // tps)
    return KernelPlan(bq, bn, fp, kp, segments, tps)


def _kernel(
    q_ref,      # (BQ, FP)  query block, zero-padded columns
    qn_ref,     # (BQ,)     query norms
    ex_ref,     # (BQ,)     excluded row per query (-1 = none)
    c_ref,      # (N, F)    catalog, row-major, whole array
    cn_ref,     # (N,)      catalog norms, whole array
    nv_ref,     # ()        number of valid catalog rows
    os_ref,     # (BQ, KP)  this segment's top-k scores
    oi_ref,     # (BQ, KP)  this segment's top-k rows
    *,
    f: int,
    k: int,
    bn: int,
    tps: int,
    eps: float,
):
    seg = pl.program_id(1)
    q = q_ref[...]
    qn = qn_ref[...]
    ex = ex_ref[...]
    nv = nv_ref[()]
    bq, fp = q.shape
    kp = os_ref.shape[1]
    cols = jnp.arange(fp, dtype=jnp.int32)
    slot = jnp.arange(kp, dtype=jnp.int32)[None, :]
    real_slot = slot < k

    seg_start = seg * (tps * bn)
    ntiles = jnp.clip(pl.cdiv(nv - seg_start, bn), 0, tps)

    def worst_of(rs):
        return jnp.min(jnp.where(real_slot, rs, POS_INF), axis=1)

    def insert_round(carry):
        sc, rs, ri, rows = carry
        m = jnp.max(sc, axis=1)                                     # (BQ,)
        am = jnp.min(
            jnp.where(sc == m[:, None], rows[None, :], _BIG_I32), axis=1
        )                                                           # lowest row
        worst = worst_of(rs)
        # evict the worst kept slot; among equal scores the highest row
        cand = real_slot & (rs == worst[:, None])
        ev_row = jnp.max(jnp.where(cand, ri, -2), axis=1)
        ev_slot = jnp.max(
            jnp.where(cand & (ri == ev_row[:, None]), slot, -1), axis=1
        )
        upd = (m > worst)[:, None] & (slot == ev_slot[:, None])
        rs = jnp.where(upd, m[:, None], rs)
        ri = jnp.where(upd, am[:, None], ri)
        sc = jnp.where(rows[None, :] == am[:, None], NEG_INF, sc)
        return sc, rs, ri, rows

    def needs_insert(carry):
        sc, rs, _, _ = carry
        beats = jnp.max(sc, axis=1) > worst_of(rs)
        return jnp.sum(beats.astype(jnp.int32)) > 0    # no reduce_or in Triton

    def tile(t, carry):
        rs, ri = carry
        start = seg_start + t * bn
        rows = start + jnp.arange(bn, dtype=jnp.int32)
        valid = rows < nv
        c = plgpu.load(
            c_ref.at[pl.ds(start, bn), pl.ds(0, fp)],
            mask=valid[:, None] & (cols < f)[None, :],
            other=0.0,
        )                                                           # (BN, FP)
        cn = plgpu.load(cn_ref.at[pl.ds(start, bn)], mask=valid, other=0.0)
        dots = pl.dot(q, c, trans_b=True, precision=jax.lax.Precision.HIGHEST)
        denom = qn[:, None] * cn[None, :]
        guard = denom > eps
        sc = jnp.where(
            guard,
            jnp.clip(dots / jnp.where(guard, denom, 1.0), -1.0, 1.0),
            0.0,
        )
        bad = ~valid[None, :] | (rows[None, :] == ex[:, None])
        sc = jnp.where(bad, NEG_INF, sc)
        _, rs, ri, _ = jax.lax.while_loop(
            needs_insert, insert_round, (sc, rs, ri, rows)
        )
        return rs, ri

    rs = jnp.full((bq, kp), NEG_INF, jnp.float32)
    ri = jnp.full((bq, kp), -1, jnp.int32)
    rs, ri = jax.lax.fori_loop(0, ntiles, tile, (rs, ri))
    os_ref[...] = jnp.where(real_slot, rs, NEG_INF)
    oi_ref[...] = jnp.where(real_slot, ri, -1)


def _segment_topk(queries, q_norms, excl, features, norms, valid, *,
                  k: int, eps: float, p: KernelPlan, interpret: bool):
    """Run the kernel: (Bp, S * KP) candidate scores and rows."""
    bp = queries.shape[0]
    f = features.shape[1]
    grid = (bp // p.bq, p.segments)
    kernel = functools.partial(
        _kernel, f=f, k=k, bn=p.bn, tps=p.tiles_per_segment, eps=eps
    )
    whole = pl.BlockSpec(memory_space=pl.ANY)
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[
            pl.BlockSpec((p.bq, p.fp), lambda i, s: (i, 0)),
            pl.BlockSpec((p.bq,), lambda i, s: (i,)),
            pl.BlockSpec((p.bq,), lambda i, s: (i,)),
            whole,
            whole,
            whole,
        ],
        out_specs=[
            pl.BlockSpec((p.bq, p.kp), lambda i, s: (i, s)),
            pl.BlockSpec((p.bq, p.kp), lambda i, s: (i, s)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((bp, p.segments * p.kp), jnp.float32),
            jax.ShapeDtypeStruct((bp, p.segments * p.kp), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="fused_cosine_topk",
    )(queries, q_norms, excl, features, norms, valid)


@functools.partial(jax.jit, static_argnames=("k", "eps", "interpret"))
def fused_topk(
    queries: jnp.ndarray,        # (B, F)
    features: jnp.ndarray,       # (N, F) row-major catalog
    norms: jnp.ndarray,          # (N,)
    exclude_rows: jnp.ndarray,   # (B,) row to drop per query, -1 = none
    valid: jnp.ndarray,          # () rows >= valid score -inf
    *,
    k: int,
    eps: float,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact top-k cosine retrieval: (scores (B, k), rows (B, k))."""
    b, f = queries.shape
    n = features.shape[0]
    if not 1 <= k <= KMAX or f > FMAX:
        raise ValueError(f"kernel takes k <= {KMAX}, F <= {FMAX}; got {k}, {f}")
    p = plan(b, n, f, k)
    bp = -(-b // p.bq) * p.bq
    queries = queries.astype(jnp.float32)
    q_norms = jnp.linalg.norm(queries, axis=1)
    q_pad = jnp.zeros((bp, p.fp), jnp.float32).at[:b, :f].set(queries)
    qn_pad = jnp.zeros((bp,), jnp.float32).at[:b].set(q_norms)
    ex_pad = jnp.full((bp,), -1, jnp.int32).at[:b].set(
        exclude_rows.astype(jnp.int32)
    )
    cand_s, cand_i = _segment_topk(
        q_pad, qn_pad, ex_pad, features, norms,
        jnp.asarray(valid, jnp.int32),
        k=k, eps=eps, p=p, interpret=interpret,
    )
    return merge_topk_deterministic(cand_s[:b], cand_i[:b], k)
