"""The fused Triton score + top-k kernel (ops/pallas/fused_topk.py).

On the CPU the kernel runs in Pallas interpret mode; its lowering to
Triton IR for CUDA is checked here too (that needs no card).  The
``gpu``-marked cases run the compiled kernel and skip without a GPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spotify_recommender_tpu.ops.pallas import fused_topk as ft
from spotify_recommender_tpu.ops.similarity import exact_topk
from spotify_recommender_tpu.ops.topk import merge_topk_deterministic


def run_case(n, f, b, k, *, exclude=True, valid=None, dup=False, zero=False,
             seed=0, interpret=True):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, f), dtype=np.float32)
    if dup:
        feats[[7, 11, n - 1]] = feats[3]
    if zero:
        feats[rng.integers(0, n, max(1, n // 8))] = 0.0
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    rows = rng.integers(0, n, b).astype(np.int32)
    if dup:
        rows[0] = 3
    queries = feats[rows]
    excl = rows if exclude else np.full(b, -1, np.int32)
    nv = n if valid is None else valid
    s, i = ft.fused_topk(
        jnp.asarray(queries), jnp.asarray(feats), jnp.asarray(norms),
        jnp.asarray(excl), jnp.int32(nv), k=k, eps=1e-8,
        interpret=interpret,
    )
    # oracle over the valid prefix; slots past it are (-inf, -1)
    kk = min(k, nv)
    os_, oi = exact_topk(
        jnp.asarray(queries), jnp.asarray(feats[:nv]),
        jnp.asarray(norms[:nv]), jnp.asarray(excl), k=kk,
    )
    os_, oi = np.asarray(os_), np.asarray(oi)
    oi = np.where(np.isneginf(os_), -1, oi)
    s, i = np.asarray(s), np.asarray(i)
    assert s.shape == (b, k) and i.shape == (b, k)
    np.testing.assert_array_equal(i[:, :kk], oi)
    np.testing.assert_allclose(s[:, :kk], os_, rtol=0, atol=1e-6)
    assert np.all(np.isneginf(s[:, kk:])) and np.all(i[:, kk:] == -1)


def boundary_n(b, f, k, extra):
    """A catalog size at an exact segment boundary (+ extra rows)."""
    bn = ft.plan(b, 10_000, f, k).bn
    return bn * ft.MIN_TILES_PER_SEGMENT * 3 + extra


INTERPRET_CASES = [
    # id, n, f, b, k, kwargs
    ("b1_k10", 1000, 12, 1, 10, {}),
    ("b3_k1", 777, 12, 3, 1, {}),
    ("b20_k10_no_excl", 300, 12, 20, 10, {"exclude": False}),
    ("f64_b8_k32", 2000, 64, 8, 32, {}),
    ("k64_small_n", 100, 12, 2, 64, {}),
    ("duplicates", 1500, 12, 4, 10, {"dup": True}),
    ("zero_rows", 900, 12, 5, 10, {"zero": True}),
    ("valid_prefix", 1000, 12, 4, 10, {"valid": 613}),
    ("no_valid_rows", 256, 12, 2, 5, {"valid": 0}),
    ("segment_boundary", boundary_n(1, 12, 10, 0), 12, 1, 10, {}),
    ("segment_boundary_plus1", boundary_n(1, 12, 10, 1), 12, 1, 10, {}),
    ("segment_boundary_minus1", boundary_n(1, 12, 10, -1), 12, 1, 10, {}),
]


@pytest.mark.parametrize(
    "n,f,b,k,kw", [c[1:] for c in INTERPRET_CASES],
    ids=[c[0] for c in INTERPRET_CASES],
)
def test_interpret_matches_oracle(n, f, b, k, kw):
    run_case(n, f, b, k, **kw)


@pytest.mark.parametrize(
    "b,n,f,k",
    [(1, 10_000_000, 12, 10), (1024, 10_000_000, 12, 10),
     (1024, 1_000_000, 64, 10), (3, 37, 12, 10), (64, 262_145, 12, 32),
     (200, 5000, 128, 64)],
)
def test_plan_covers_catalog_and_fills_card(b, n, f, k):
    p = ft.plan(b, n, f, k)
    for size in (p.bq, p.bn, p.fp, p.kp):
        assert size & (size - 1) == 0
    assert p.bq >= 16 and p.fp >= max(16, f) and k <= p.kp
    span = p.tiles_per_segment * p.bn
    # every row in exactly one segment, no empty segment
    assert p.segments * span >= n > (p.segments - 1) * span
    # about TARGET_PROGRAMS in flight (rounding tiles per segment up may
    # drop a few segments), unless the catalog is too short for that
    programs = -(-b // p.bq) * p.segments
    tiles = -(-n // p.bn)
    want = min(ft.TARGET_PROGRAMS, tiles // ft.MIN_TILES_PER_SEGMENT)
    assert 2 * programs > want


@pytest.mark.parametrize("k,f", [(ft.KMAX + 1, 12), (10, ft.FMAX + 1)])
def test_rejects_shapes_past_its_limits(k, f):
    x = jnp.ones((64, f), jnp.float32)
    with pytest.raises(ValueError, match="kernel takes"):
        ft.fused_topk(
            x[:2], x, jnp.ones(64), jnp.full((2,), -1, jnp.int32),
            jnp.int32(64), k=k, eps=1e-8, interpret=True,
        )


@pytest.mark.parametrize(
    "f,b,k", [(12, 1, 10), (12, 1024, 10), (64, 1024, 10), (12, 3, 1),
              (64, 16, 64)],
)
def test_lowers_to_triton_for_cuda(f, b, k):
    """The Pallas -> Triton IR lowering runs without a card, so every
    primitive the kernel uses must have a Triton lowering rule."""
    n = 100_003
    args = (
        jax.ShapeDtypeStruct((b, f), jnp.float32),
        jax.ShapeDtypeStruct((n, f), jnp.float32),
        jax.ShapeDtypeStruct((n,), jnp.float32),
        jax.ShapeDtypeStruct((b,), jnp.int32),
        jax.ShapeDtypeStruct((), jnp.int32),
    )
    fn = jax.jit(functools.partial(ft.fused_topk, k=k, eps=1e-8))
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "fused_cosine_topk" in text


def test_merge_prefers_lower_row_on_ties():
    scores = jnp.asarray([[0.5, 0.9, 0.5, 0.9, -jnp.inf]])
    rows = jnp.asarray([[40, 30, 20, 10, -1]], jnp.int32)
    s, i = merge_topk_deterministic(scores, rows, 4)
    np.testing.assert_array_equal(np.asarray(i), [[10, 30, 20, 40]])
    np.testing.assert_array_equal(
        np.asarray(s), np.float32([[0.9, 0.9, 0.5, 0.5]])
    )


def test_merge_treats_signed_zeros_as_tied():
    scores = jnp.asarray([[0.0, -0.0, 0.0]])
    rows = jnp.asarray([[9, 2, 5]], jnp.int32)
    _, i = merge_topk_deterministic(scores, rows, 3)
    np.testing.assert_array_equal(np.asarray(i), [[2, 5, 9]])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,f,b,k", [(100_003, 12, 4, 10), (50_000, 64, 1024, 10),
                (20_011, 12, 1, 64)],
)
def test_compiled_matches_oracle(n, f, b, k):
    run_case(n, f, b, k, dup=True, interpret=False)
