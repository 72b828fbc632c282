"""Matrix factorization for implicit feedback: ALS + SGD trainers.

The reference has no training at all (SURVEY.md §2: features are
hand-crafted; scope extension per BASELINE.json config 3).  Design:

- **iALS** (Hu/Koren/Volinsky 2008, via PAPERS.md iALS++ background):
  alternating ridge solves with the Gramian trick —
  ``A_u = YᵀY + λI + Σ_i α·c_ui · y_i y_iᵀ``, ``b_u = Σ_i (1 + α·c_ui) y_i``.
  Users are processed as one batched program: interactions are padded to a
  fixed ``max_degree`` (static shapes for XLA), per-user normal matrices
  are built with batched einsums at `Precision.HIGHEST` (no TF32 on a
  GPU), and all solves run as **one batched Cholesky**
  (`jax.scipy.linalg.cho_solve`) — thousands of D×D solves at D ≤ 128.
- **SGD**: confidence-weighted MSE on positives + sampled uniform
  negatives, optax Adam, jit-compiled step.  Gradients `psum` over the
  "data" mesh axis when run under shard_map (see train_step_dp).
- Both factor tables live on device; the user/item alternation is
  embarrassingly data-parallel over the solved axis (each device solves a
  row-shard of users against a replicated item table — the standard ALS
  scale-out; sharded-table all-to-all serving lives in the two-tower path).

Evaluation reuses the retrieval stack: recall@k / NDCG@k by scoring the
factorized embeddings with the same exact top-k kernel that serves the
content-based path.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from spotify_recommender_tpu.core.config import MFConfig
from spotify_recommender_tpu.core.logging import get_logger, PhaseTimer

log = get_logger(__name__)


# --------------------------------------------------------------------------
# Interaction data
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Interactions:
    """Implicit-feedback matrix in padded-ragged (static-shape) form.

    ``item_idx[u, j]`` = j-th item of user u (0-padded), valid where
    ``mask[u, j]``; ``confidence`` holds raw counts (0 where padded).
    """

    item_idx: np.ndarray     # (U, max_degree) int32
    confidence: np.ndarray   # (U, max_degree) float32
    mask: np.ndarray         # (U, max_degree) bool
    num_users: int
    num_items: int

    @classmethod
    def from_coo(
        cls,
        users: np.ndarray,
        items: np.ndarray,
        counts: np.ndarray,
        num_users: Optional[int] = None,
        num_items: Optional[int] = None,
        max_degree: Optional[int] = None,
    ) -> "Interactions":
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        counts = np.asarray(counts, np.float32)
        nu = int(num_users or users.max() + 1)
        ni = int(num_items or items.max() + 1)
        order = np.lexsort((items, users))
        users, items, counts = users[order], items[order], counts[order]
        degrees = np.bincount(users, minlength=nu)
        md = int(max_degree or degrees.max())
        # fully vectorized padded-ragged construction (no per-user Python
        # loop — at north-star scale that loop dominated ALS wall-clock):
        # position of each interaction within its user's sorted run
        starts = np.concatenate([[0], np.cumsum(degrees)[:-1]])
        pos = np.arange(len(users)) - np.repeat(starts, degrees)
        keep = pos < md
        item_idx = np.zeros((nu, md), np.int32)
        conf = np.zeros((nu, md), np.float32)
        mask = np.zeros((nu, md), bool)
        item_idx[users[keep], pos[keep]] = items[keep]
        conf[users[keep], pos[keep]] = counts[keep]
        mask[users[keep], pos[keep]] = True
        return cls(item_idx, conf, mask, nu, ni)

    def transpose(self, max_degree: Optional[int] = None) -> "Interactions":
        """Item-major view (for the item half-step of ALS)."""
        uu, jj = np.nonzero(self.mask)  # row-major: ascending user order
        return Interactions.from_coo(
            self.item_idx[uu, jj].astype(np.int64),  # items become "users"
            uu.astype(np.int64),
            self.confidence[uu, jj],
            num_users=self.num_items,
            num_items=self.num_users,
            max_degree=max_degree,
        )


def synthetic_interactions(
    num_users: int = 2000,
    num_items: int = 1000,
    latent_dim: int = 8,
    density: float = 0.02,
    seed: int = 0,
) -> Tuple[Interactions, np.ndarray, np.ndarray]:
    """Low-rank synthetic play counts (ground-truth factors returned for
    sanity checks)."""
    rng = np.random.default_rng(seed)
    tu = rng.normal(size=(num_users, latent_dim)).astype(np.float32)
    ti = rng.normal(size=(num_items, latent_dim)).astype(np.float32)
    logits = tu @ ti.T
    n_obs = int(density * num_users * num_items)
    # observation probability follows affinity (sharpened softmax sampling
    # so the preference signal is clearly recoverable by MF)
    p = np.exp(2.0 * logits)
    p /= p.sum()
    flat = rng.choice(num_users * num_items, size=n_obs, replace=False, p=p.ravel())
    users, items = np.divmod(flat, num_items)
    counts = 1.0 + rng.poisson(3.0, size=n_obs).astype(np.float32)
    inter = Interactions.from_coo(users, items, counts, num_users, num_items)
    return inter, tu, ti


# --------------------------------------------------------------------------
# ALS
# --------------------------------------------------------------------------


# ALS products pin true fp32: an H100 would otherwise be free to run them
# in TF32 (about three decimal digits).
_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def _als_block_rows(n: int, md: int, d: int) -> int:
    """Row-block size keeping the half-step's live tensors ~<=1 GB: the
    batched normal matrices are (rows, D, D) and the gathered neighbor
    vectors (rows, md, D) — at north-star scale (1M users x d=64) the
    unblocked versions alone would want 16+ GB of HBM."""
    per_row = 4 * d * (d + 2 * max(1, md))
    return max(1024, min(n, 1_000_000_000 // per_row))


def _als_solve(
    other: jnp.ndarray,        # (M, D) fixed factor table
    item_idx: jnp.ndarray,     # (N, md) int32 neighbor ids into `other`
    confidence: jnp.ndarray,   # (N, md) float32
    mask: jnp.ndarray,         # (N, md) bool
    reg: float,
    alpha: float,
    solve_block: int = 0,
) -> jnp.ndarray:
    """One ALS half-step: re-solve every row given the fixed `other` table.

    Implements the implicit-feedback normal equations with the Gramian
    trick; solves run as batched Cholesky factorizations, processed in
    `solve_block`-row blocks via `lax.map` (0 = auto-size to ~1 GB of
    live per-block tensors) so memory stays bounded at any user count.
    Fully-masked rows (padding) solve (G + λI) x = 0 → 0, harmlessly.
    """
    n, md = item_idx.shape
    d = other.shape[1]
    gram = jnp.dot(
        other.T, other, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )                                                     # (D, D)
    eye = reg * jnp.eye(d, dtype=other.dtype)

    def solve_rows(idx, conf, msk):
        y = other[idx]                                    # (r, md, D)
        w = jnp.where(msk, alpha * conf, 0.0)             # (r, md)
        cpref = jnp.where(msk, 1.0 + alpha * conf, 0.0)
        # A_r = G + λI + Σ_j w_rj y_rj y_rjᵀ  (batched outer-product)
        a = gram[None] + _einsum("nj,njd,nje->nde", w, y, y) + eye[None]
        b = _einsum("nj,njd->nd", cpref, y)               # (r, D)
        chol = jax.scipy.linalg.cho_factor(a, lower=True)
        return jax.scipy.linalg.cho_solve(chol, b)

    block = solve_block or _als_block_rows(n, md, d)
    if n <= block:
        return solve_rows(item_idx, confidence, mask)
    nb = -(-n // block)
    npad = nb * block - n
    idx3 = jnp.pad(item_idx, ((0, npad), (0, 0))).reshape(nb, block, md)
    conf3 = jnp.pad(confidence, ((0, npad), (0, 0))).reshape(nb, block, md)
    mask3 = jnp.pad(mask, ((0, npad), (0, 0))).reshape(nb, block, md)
    out = jax.lax.map(
        lambda t: solve_rows(*t), (idx3, conf3, mask3)
    )                                                     # (nb, block, D)
    return out.reshape(nb * block, d)[:n]


@partial(jax.jit, static_argnames=("reg", "alpha"))
def _als_half_step(
    solve_for: jnp.ndarray,    # unused placeholder, keeps call symmetry
    other: jnp.ndarray,
    item_idx: jnp.ndarray,
    confidence: jnp.ndarray,
    mask: jnp.ndarray,
    reg: float,
    alpha: float,
) -> jnp.ndarray:
    del solve_for
    return _als_solve(other, item_idx, confidence, mask, reg, alpha)


def _als_pp_solve(
    other: jnp.ndarray,        # (M, D) fixed factor table
    item_idx: jnp.ndarray,     # (N, md) int32 neighbor ids into `other`
    confidence: jnp.ndarray,   # (N, md) float32
    mask: jnp.ndarray,         # (N, md) bool
    x0: jnp.ndarray,           # (N, D) current factors (warm start)
    reg: float,
    alpha: float,
    subspace: int,
    solve_block: int = 0,
) -> jnp.ndarray:
    """iALS++ half-step: subspace block-coordinate descent
    (Rendle et al., "iALS++: Speeding up Matrix Factorization with
    Subspace Optimization", arXiv:2110.14044 — PAPERS.md).

    Instead of one D x D normal-equation solve per row, one sweep updates
    D/subspace coordinate blocks with `subspace`-sized solves, keeping a
    per-(row, neighbor) prediction cache that is corrected incrementally
    after each block.  The dominant cost drops from
    O(nnz * D^2 + N * D^3) to O(nnz * D * k + N * D * k^2), a ~D/k
    speedup per sweep at D=64/k=16; one sweep per half-step is the
    standard schedule (it is exact Gauss-Seidel on the per-row quadratic,
    so with subspace == D it reproduces the full solve).
    """
    n, md = item_idx.shape
    d = other.shape[1]
    k = max(1, min(subspace, d))
    assert d % k == 0, f"subspace {k} must divide embedding dim {d}"
    gram = jnp.dot(
        other.T, other, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )                                                     # (D, D)
    eye_k = reg * jnp.eye(k, dtype=other.dtype)

    def sweep_rows(idx, conf, msk, x):
        y = other[idx]                                    # (r, md, D)
        w = jnp.where(msk, alpha * conf, 0.0)
        cpref = jnp.where(msk, 1.0 + alpha * conf, 0.0)
        pred = _einsum("njd,nd->nj", y, x)                # (r, md) cache
        for s in range(0, d, k):
            ys = y[:, :, s : s + k]                       # (r, md, k)
            a_ss = (
                gram[s : s + k, s : s + k][None]
                + _einsum("nj,nja,njb->nab", w, ys, ys)
                + eye_k[None]
            )
            b_s = _einsum("nj,nja->na", cpref, ys)
            # (A x)_S = (G x)_S + sum_j w_j pred_j y_jS + lambda x_S
            ax_s = (
                _einsum("nd,da->na", x, gram[:, s : s + k])
                + _einsum("nj,nja->na", w * pred, ys)
                + reg * x[:, s : s + k]
            )
            chol = jax.scipy.linalg.cho_factor(a_ss, lower=True)
            delta = jax.scipy.linalg.cho_solve(chol, b_s - ax_s)  # (r, k)
            x = x.at[:, s : s + k].add(delta)
            pred = pred + _einsum("na,nja->nj", delta, ys)
        return x

    block = solve_block or _als_block_rows(n, md, max(k, d // 4))
    if n <= block:
        return sweep_rows(item_idx, confidence, mask, x0)
    nb = -(-n // block)
    npad = nb * block - n
    idx3 = jnp.pad(item_idx, ((0, npad), (0, 0))).reshape(nb, block, md)
    conf3 = jnp.pad(confidence, ((0, npad), (0, 0))).reshape(nb, block, md)
    mask3 = jnp.pad(mask, ((0, npad), (0, 0))).reshape(nb, block, md)
    x3 = jnp.pad(x0, ((0, npad), (0, 0))).reshape(nb, block, d)
    out = jax.lax.map(lambda t: sweep_rows(*t), (idx3, conf3, mask3, x3))
    return out.reshape(nb * block, d)[:n]


@partial(jax.jit, static_argnames=("reg", "alpha", "subspace"))
def _als_pp_half_step(
    solve_for: jnp.ndarray,
    other: jnp.ndarray,
    item_idx: jnp.ndarray,
    confidence: jnp.ndarray,
    mask: jnp.ndarray,
    reg: float,
    alpha: float,
    subspace: int,
) -> jnp.ndarray:
    return _als_pp_solve(
        other, item_idx, confidence, mask, solve_for, reg, alpha, subspace
    )


def make_sharded_half_step(mesh, reg: float, alpha: float, axis: str = "catalog"):
    """ALS half-step sharded over the solve axis: each device solves its
    row-shard of users (or items) against the replicated `other` table —
    the canonical ALS scale-out (solves are row-independent).  Inputs must
    be padded to a multiple of the axis size (train_als handles this)."""
    from jax.sharding import PartitionSpec as P

    body = partial(_als_solve, reg=reg, alpha=alpha)
    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P(axis, None), P(axis, None), P(axis, None)),
            out_specs=P(axis, None),
            check_vma=False,
        )
    )


def _als_solve_sharded_table(
    other_shard: jnp.ndarray,  # (M/shards, D) row-shard of the fixed table
    item_idx: jnp.ndarray,     # (N/shards, md) this shard's solve rows
    confidence: jnp.ndarray,
    mask: jnp.ndarray,
    reg: float,
    alpha: float,
    axis: str,
) -> jnp.ndarray:
    """ALS half-step where the fixed `other` table is ALSO row-sharded
    (for factor tables beyond one chip's HBM — SURVEY §7 step 4).

    The neighbor gather becomes a **sharded embedding lookup** — the
    all-gather(ids) → masked-local-gather → psum_scatter exchange of
    parallel/embedding.sharded_ids_lookup — and the Gramian is assembled
    by psum of per-shard partials.  Each device then solves only its
    row-shard of the output table; no device ever holds a full table.
    """
    from spotify_recommender_tpu.parallel.embedding import sharded_ids_lookup

    d = other_shard.shape[1]
    gram = jax.lax.psum(
        jnp.dot(
            other_shard.T, other_shard,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ),
        axis,
    )                                                     # (D, D) global
    y = sharded_ids_lookup(other_shard, item_idx, axis)   # (n, md, D)
    w = jnp.where(mask, alpha * confidence, 0.0)
    cpref = jnp.where(mask, 1.0 + alpha * confidence, 0.0)
    a = (
        gram[None]
        + _einsum("nj,njd,nje->nde", w, y, y)
        + reg * jnp.eye(d, dtype=other_shard.dtype)[None]
    )
    b = _einsum("nj,njd->nd", cpref, y)
    chol = jax.scipy.linalg.cho_factor(a, lower=True)
    return jax.scipy.linalg.cho_solve(chol, b)


def make_sharded_table_half_step(
    mesh, reg: float, alpha: float, axis: str = "catalog"
):
    """Half-step with BOTH tables row-sharded over `axis` (nothing
    replicated): in + out factor tables live distributed; the exchange is
    the embedding lookup's psum over the interconnect."""
    from jax.sharding import PartitionSpec as P

    body = partial(_als_solve_sharded_table, reg=reg, alpha=alpha, axis=axis)
    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(
                P(axis, None), P(axis, None), P(axis, None), P(axis, None)
            ),
            out_specs=P(axis, None),
            check_vma=False,
        )
    )


def _pad_rows(x: np.ndarray, multiple: int) -> np.ndarray:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return np.concatenate(
        [x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0
    )


def train_als(
    inter: Interactions,
    config: MFConfig,
    item_view: Optional[Interactions] = None,
    callback=None,
    mesh: Optional[jax.sharding.Mesh] = None,
    shard_tables: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    subspace: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full alternating loop. Returns (user_factors, item_factors).

    With a mesh, each half-step's solves are row-sharded over the mesh's
    "catalog" axis (device-data-parallel ALS).  With `shard_tables`, the
    factor tables themselves are row-sharded too (nothing replicated) and
    neighbor vectors are exchanged via the sharded-embedding lookup — for
    tables beyond one chip's HBM.  With `checkpoint_dir`, factor tables
    checkpoint every `checkpoint_every` iterations (Orbax) and training
    resumes from the latest checkpoint if one exists.  With `subspace` > 0
    (must divide embedding_dim; single-device only), half-steps use the
    iALS++ block-coordinate sweep (arXiv:2110.14044) — ~dim/subspace
    cheaper per sweep at equal asymptotic fixed point."""
    rng = np.random.default_rng(config.seed)
    d = config.embedding_dim
    scale = 1.0 / np.sqrt(d)
    if item_view is None:
        item_view = inter.transpose()

    n_shards = mesh.shape["catalog"] if mesh is not None else 1
    u_idx = jnp.asarray(_pad_rows(inter.item_idx, n_shards))
    u_conf = jnp.asarray(_pad_rows(inter.confidence, n_shards))
    u_mask = jnp.asarray(_pad_rows(inter.mask, n_shards))
    i_idx = jnp.asarray(_pad_rows(item_view.item_idx, n_shards))
    i_conf = jnp.asarray(_pad_rows(item_view.confidence, n_shards))
    i_mask = jnp.asarray(_pad_rows(item_view.mask, n_shards))
    # init with UNPADDED shapes so results are invariant to shard count,
    # then zero-pad to the sharded row count
    users = _pad_rows(
        (rng.normal(size=(inter.num_users, d)) * scale).astype(np.float32),
        n_shards,
    )
    items = _pad_rows(
        (rng.normal(size=(inter.num_items, d)) * scale).astype(np.float32),
        n_shards,
    )
    if subspace and mesh is not None:
        raise ValueError(
            "subspace (iALS++) is single-device for now; drop the mesh "
            "or the subspace"
        )
    if mesh is not None and shard_tables:
        # distributed placement: no device holds a full table
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P("catalog", None))
        users = jax.device_put(jnp.asarray(users), sh)
        items = jax.device_put(jnp.asarray(items), sh)
        step = make_sharded_table_half_step(mesh, config.reg, config.alpha)

        def half(_, other, idx, conf, mask):
            return step(other, idx, conf, mask)

    elif mesh is not None:
        users = jnp.asarray(users)
        items = jnp.asarray(items)
        step = make_sharded_half_step(mesh, config.reg, config.alpha)

        def half(_, other, idx, conf, mask):
            return step(other, idx, conf, mask)

    else:
        users = jnp.asarray(users)
        items = jnp.asarray(items)
        if subspace:
            half = partial(
                _als_pp_half_step,
                reg=config.reg, alpha=config.alpha, subspace=subspace,
            )
        else:
            half = partial(
                _als_half_step, reg=config.reg, alpha=config.alpha
            )

    ckpt_mgr = None
    start_iter = 0
    if checkpoint_dir is not None:
        from spotify_recommender_tpu.train.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(checkpoint_dir)
        latest = ckpt_mgr.latest_step()
        if latest is not None:
            state = ckpt_mgr.restore(
                latest, template={"users": users, "items": items}
            )
            users, items = state["users"], state["items"]
            start_iter = latest + 1
            log.info("resumed ALS from iteration %d", start_iter)

    timer = PhaseTimer()
    for it in range(start_iter, config.num_iterations):
        with timer.phase(f"iter{it}"):
            users = half(users, items, u_idx, u_conf, u_mask)
            items = half(items, users, i_idx, i_conf, i_mask)
            jax.block_until_ready(items)
        if callback is not None:
            callback(it, users[: inter.num_users], items[: inter.num_items])
        if ckpt_mgr is not None and (
            (it + 1) % checkpoint_every == 0
            or it == config.num_iterations - 1
        ):
            ckpt_mgr.save(it, {"users": users, "items": items}, force=True)
    if ckpt_mgr is not None:
        ckpt_mgr.wait()
        ckpt_mgr.close()
    log.info("ALS done: %s", timer.report())
    return (
        np.asarray(users[: inter.num_users]),
        np.asarray(items[: inter.num_items]),
    )


# --------------------------------------------------------------------------
# SGD variant
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SGDState:
    users: jnp.ndarray
    items: jnp.ndarray
    opt_state: optax.OptState


def _sgd_loss(
    params: Dict[str, jnp.ndarray],
    u: jnp.ndarray,           # (B,) user ids
    i_pos: jnp.ndarray,       # (B,) positive item ids
    conf: jnp.ndarray,        # (B,) confidence
    i_neg: jnp.ndarray,       # (B, n_neg) sampled negatives
    reg: float,
    alpha: float,
) -> jnp.ndarray:
    """Confidence-weighted implicit MSE (iALS objective, sampled)."""
    eu = params["users"][u]                    # (B, D)
    ep = params["items"][i_pos]                # (B, D)
    en = params["items"][i_neg]                # (B, n_neg, D)
    pos_pred = jnp.sum(eu * ep, axis=1)
    neg_pred = jnp.einsum("bd,bnd->bn", eu, en)
    w = 1.0 + alpha * conf
    loss_pos = jnp.mean(w * (1.0 - pos_pred) ** 2)
    loss_neg = jnp.mean(neg_pred**2)
    l2 = reg * (jnp.mean(jnp.sum(eu**2, 1)) + jnp.mean(jnp.sum(ep**2, 1)))
    return loss_pos + loss_neg + l2


@partial(jax.jit, static_argnames=("optimizer", "reg", "alpha", "axis_name"))
def sgd_step(
    params: Dict[str, jnp.ndarray],
    opt_state: optax.OptState,
    batch: Dict[str, jnp.ndarray],
    optimizer,
    reg: float,
    alpha: float,
    axis_name: Optional[str] = None,
):
    loss, grads = jax.value_and_grad(_sgd_loss)(
        params, batch["user"], batch["item"], batch["conf"], batch["neg"],
        reg, alpha,
    )
    if axis_name is not None:
        grads = jax.lax.pmean(grads, axis_name)
        loss = jax.lax.pmean(loss, axis_name)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss


def train_sgd(
    inter: Interactions,
    config: MFConfig,
    num_steps: int = 1000,
    n_neg: int = 4,
    mesh: Optional[jax.sharding.Mesh] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 200,
) -> Tuple[np.ndarray, np.ndarray]:
    """SGD/Adam training loop. With a mesh, the batch is sharded over the
    "data" axis and gradients are psum'd (data parallelism).  With
    `checkpoint_dir`, params + optimizer state checkpoint every
    `checkpoint_every` steps (Orbax) and training resumes from the latest
    checkpoint (the numpy batch RNG is re-seeded to the resume step so the
    resumed run replays the same sample sequence)."""
    rng = np.random.default_rng(config.seed)
    d = config.embedding_dim
    scale = 1.0 / np.sqrt(d)
    params = {
        "users": jnp.asarray(
            rng.normal(size=(inter.num_users, d)) * scale, jnp.float32
        ),
        "items": jnp.asarray(
            rng.normal(size=(inter.num_items, d)) * scale, jnp.float32
        ),
    }
    optimizer = optax.adam(config.learning_rate)
    opt_state = optimizer.init(params)

    # flatten observed pairs for sampling
    uu, jj = np.nonzero(inter.mask)
    users_f = uu.astype(np.int32)
    items_f = inter.item_idx[uu, jj]
    conf_f = inter.confidence[uu, jj]
    n_obs = len(users_f)

    if mesh is not None and mesh.shape.get("data", 1) > 1:
        from jax.sharding import PartitionSpec as P

        def _dp_body(params, opt_state, user, item, conf, neg):
            batch = {"user": user, "item": item, "conf": conf, "neg": neg}
            return sgd_step(
                params, opt_state, batch,
                optimizer=optimizer, reg=config.reg, alpha=config.alpha,
                axis_name="data",
            )

        dp_step = jax.jit(
            jax.shard_map(
                _dp_body,
                mesh=mesh,
                in_specs=(P(), P(), P("data"), P("data"), P("data"),
                          P("data", None)),
                out_specs=(P(), P(), P()),
                check_vma=False,
            )
        )

        def step_fn(params, opt_state, batch):
            return dp_step(
                params, opt_state,
                batch["user"], batch["item"], batch["conf"], batch["neg"],
            )

        # global batch must divide evenly over the data axis
        nd = mesh.shape["data"]
        b = max(nd, (min(config.batch_size, n_obs) // nd) * nd)
    else:
        step_fn = partial(
            sgd_step,
            optimizer=optimizer,
            reg=config.reg,
            alpha=config.alpha,
            axis_name=None,
        )
        b = min(config.batch_size, n_obs)

    ckpt_mgr = None
    start_step = 0
    if checkpoint_dir is not None:
        from spotify_recommender_tpu.train.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(checkpoint_dir)
        latest = ckpt_mgr.latest_step()
        if latest is not None:
            state = ckpt_mgr.restore(
                latest, template={"params": params, "opt_state": opt_state}
            )
            params, opt_state = state["params"], state["opt_state"]
            start_step = latest + 1
            log.info("resumed SGD-MF from step %d", start_step)

    losses = []
    for step in range(num_steps):
        sel = rng.integers(0, n_obs, size=b)
        neg = rng.integers(0, inter.num_items, size=(b, n_neg))
        if step < start_step:
            continue  # replay the RNG stream so resume == uninterrupted run
        batch = {
            "user": jnp.asarray(users_f[sel]),
            "item": jnp.asarray(items_f[sel]),
            "conf": jnp.asarray(conf_f[sel]),
            "neg": jnp.asarray(neg, jnp.int32),
        }
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if ckpt_mgr is not None and (
            (step + 1) % checkpoint_every == 0 or step == num_steps - 1
        ):
            ckpt_mgr.save(
                step, {"params": params, "opt_state": opt_state}, force=True
            )
    if ckpt_mgr is not None:
        ckpt_mgr.wait()
        ckpt_mgr.close()
    if not losses:
        losses = [float("nan")]
    log.info("SGD done: loss %.4f -> %.4f", losses[0], losses[-1])
    return np.asarray(params["users"]), np.asarray(params["items"])


# --------------------------------------------------------------------------
# Evaluation: recall@k / NDCG@k through the retrieval stack
# --------------------------------------------------------------------------


def _pad_ragged(
    rows: Dict[int, np.ndarray], keys, width: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Dict-of-arrays -> (idx (len(keys), W) int32, mask) padded-ragged."""
    lens = [len(rows.get(u, ())) for u in keys]
    w = max(1, width or (max(lens) if lens else 1))
    idx = np.zeros((len(keys), w), np.int32)
    mask = np.zeros((len(keys), w), bool)
    for r, u in enumerate(keys):
        v = rows.get(u)
        if v is not None and len(v):
            d = min(len(v), w)
            idx[r, :d] = np.asarray(v[:d], np.int32)
            mask[r, :d] = True
    return idx, mask


def evaluate_ranking_arrays(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    eval_users: np.ndarray,      # (E,) user rows to evaluate
    held_idx: np.ndarray,        # (E, H) held-out item ids (padded)
    held_mask: np.ndarray,       # (E, H) bool
    k: int = 10,
    seen_idx: Optional[np.ndarray] = None,   # (E, S) train positives
    seen_mask: Optional[np.ndarray] = None,
    user_chunk: int = 4096,
    item_chunk: int = 131072,
) -> Dict[str, float]:
    """recall@k / NDCG@k with array-native (device-scale) plumbing.

    Scoring runs through the retrieval stack's chunked MIPS top-k
    (ops/similarity.mips_topk_chunked): O(user_chunk x item_chunk) peak
    memory, train positives masked **on device** per chunk -- no
    (U_eval, N) score matrix, no per-user Python loop.
    """
    from spotify_recommender_tpu.ops.similarity import mips_topk_chunked

    items = jnp.asarray(item_factors, jnp.float32)
    e = len(eval_users)
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    cum_disc = np.concatenate([[0.0], np.cumsum(discounts)])
    recall_sum = ndcg_sum = 0.0
    n_eval = 0
    for s in range(0, e, user_chunk):
        sl = slice(s, min(s + user_chunk, e))
        u_emb = jnp.asarray(user_factors[eval_users[sl]], jnp.float32)
        si = jnp.asarray(seen_idx[sl]) if seen_idx is not None else None
        sm = jnp.asarray(seen_mask[sl]) if seen_mask is not None else None
        _, top = mips_topk_chunked(
            u_emb, items, si, sm, k=k, chunk=item_chunk
        )
        top = np.asarray(top)                                  # (C, k)
        hm = held_mask[sl]
        hi = np.where(hm, held_idx[sl], -1)                    # (C, H)
        hits = (top[:, :, None] == hi[:, None, :]).any(-1)     # (C, k)
        counts = hm.sum(1)                                     # (C,)
        valid = counts > 0
        denom = np.minimum(counts, k).clip(min=1)
        recall_sum += float((hits.sum(1) / denom)[valid].sum())
        ideal = cum_disc[np.minimum(counts, k)]
        ndcg = (hits * discounts[None, :]).sum(1) / np.where(
            ideal > 0, ideal, 1.0
        )
        ndcg_sum += float(ndcg[valid].sum())
        n_eval += int(valid.sum())
    return {
        "recall@k": recall_sum / max(n_eval, 1),
        "ndcg@k": ndcg_sum / max(n_eval, 1),
        "k": k,
        "num_eval_users": n_eval,
    }


def evaluate_ranking(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    heldout: Dict[int, np.ndarray],
    k: int = 10,
    train_mask: Optional[Dict[int, np.ndarray]] = None,
) -> Dict[str, float]:
    """recall@k and NDCG@k against held-out positives (dict API).

    Thin adapter over `evaluate_ranking_arrays` -- converts the per-user
    dicts to padded-ragged arrays and runs the chunked device path.
    """
    users = np.asarray(sorted(heldout.keys()), np.int64)
    held_idx, held_mask = _pad_ragged(heldout, users)
    seen_idx = seen_mask = None
    if train_mask is not None:
        seen_idx, seen_mask = _pad_ragged(train_mask, users)
    return evaluate_ranking_arrays(
        user_factors, item_factors, users, held_idx, held_mask,
        k=k, seen_idx=seen_idx, seen_mask=seen_mask,
    )


def split_leave_k_out_arrays(
    inter: Interactions, k: int = 2, seed: int = 0
) -> Tuple[Interactions, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized per-user split (no Python loop over users).

    Users with more than k interactions hold out exactly k uniformly-random
    ones for evaluation; others keep everything in train.  Returns
    (train, held_idx (U, k), held_mask, seen_idx (U, md), seen_mask) in the
    padded-ragged form `evaluate_ranking_arrays` consumes.
    """
    rng = np.random.default_rng(seed)
    u, md = inter.mask.shape
    degrees = inter.mask.sum(1)
    # random priority per valid slot; argsort rows -> random permutation of
    # each user's valid positions first (invalid positions sink to the end)
    r = rng.random((u, md))
    r[~inter.mask] = -1.0
    order = np.argsort(-r, axis=1, kind="stable")          # (U, md)
    rows = np.arange(u)[:, None]
    hold = np.zeros((u, md), bool)
    kk = min(k, md)
    hold[rows[:, :kk] * 0 + rows, order[:, :kk]] = True
    hold &= inter.mask
    hold[degrees <= k] = False                              # keep-all rule
    train_mask = inter.mask & ~hold

    tu, tj = np.nonzero(train_mask)
    train = Interactions.from_coo(
        tu.astype(np.int64),
        inter.item_idx[tu, tj].astype(np.int64),
        inter.confidence[tu, tj],
        inter.num_users,
        inter.num_items,
    )
    # held-out items packed left into (U, k)
    held_idx = np.zeros((u, max(1, kk)), np.int32)
    held_mask = np.zeros((u, max(1, kk)), bool)
    hu, hj = np.nonzero(hold)
    if len(hu):
        starts = np.searchsorted(hu, np.arange(u))
        pos = np.arange(len(hu)) - starts[hu]
        held_idx[hu, pos] = inter.item_idx[hu, hj]
        held_mask[hu, pos] = True
    return train, held_idx, held_mask, train.item_idx, train.mask


def split_leave_k_out(
    inter: Interactions, k: int = 2, seed: int = 0
) -> Tuple[Interactions, Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """Dict-API adapter over `split_leave_k_out_arrays` (back-compat)."""
    train, held_idx, held_mask, seen_idx, seen_mask = (
        split_leave_k_out_arrays(inter, k=k, seed=seed)
    )
    heldout: Dict[int, np.ndarray] = {}
    train_items: Dict[int, np.ndarray] = {}
    for uu in range(inter.num_users):
        hm = held_mask[uu]
        if hm.any():
            heldout[uu] = held_idx[uu][hm].astype(np.int64)
        train_items[uu] = seen_idx[uu][seen_mask[uu]].astype(np.int64)
    return train, heldout, train_items


def recommend_for_user(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    user_id: int,
    k: int = 10,
    exclude_items: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k items for one user by dot-product MIPS through the retrieval
    stack. Returns (scores (k,), item_ids (k,))."""
    from spotify_recommender_tpu.ops.similarity import topk_scores

    if user_id < 0 or user_id >= user_factors.shape[0]:
        raise IndexError(f"user {user_id} out of range")
    u = jnp.asarray(user_factors[user_id : user_id + 1], jnp.float32)
    scores = jnp.dot(
        u, jnp.asarray(item_factors, jnp.float32).T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if exclude_items is not None and len(exclude_items):
        mask = np.zeros(item_factors.shape[0], bool)
        mask[np.asarray(exclude_items, np.int64)] = True
        scores = jnp.where(jnp.asarray(mask)[None, :], -jnp.inf, scores)
    s, idx = topk_scores(scores, min(k, item_factors.shape[0]))
    return np.asarray(s)[0], np.asarray(idx)[0]


# --------------------------------------------------------------------------
# Model artifact + CLI
# --------------------------------------------------------------------------


def save_model(path: str, users: np.ndarray, items: np.ndarray, config: MFConfig):
    np.savez_compressed(
        path,
        user_factors=users,
        item_factors=items,
        embedding_dim=np.int32(config.embedding_dim),
        reg=np.float32(config.reg),
        alpha=np.float32(config.alpha),
    )
    log.info("MF model saved: %s", path)


def load_model(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as z:
        return z["user_factors"], z["item_factors"]


def load_interactions(path: str) -> Interactions:
    """Load interactions from .npz (user/item/count arrays) or CSV
    (user_id,item_id,count header)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return Interactions.from_coo(z["user"], z["item"], z["count"])
    data = np.genfromtxt(
        path, delimiter=",", names=True, dtype=None, encoding="utf-8"
    )
    cols = set(data.dtype.names or ())
    required = ("user_id", "item_id", "count")
    missing = [c for c in required if c not in cols]
    if missing:
        # columns are addressed BY NAME (a reordered header must not
        # silently swap users/items), so all three must be present
        raise ValueError(
            f"interactions CSV {path!r} is missing column(s) {missing}; "
            f"expected header with {required}, found {sorted(cols)}"
        )
    return Interactions.from_coo(
        data["user_id"].astype(np.int64),
        data["item_id"].astype(np.int64),
        data["count"].astype(np.float32),
    )


def train_from_cli(
    interactions_path: str,
    config: MFConfig,
    output: str,
    solver: str = "als",
    mesh: Optional[jax.sharding.Mesh] = None,
    shard_tables: bool = False,
    checkpoint_dir: Optional[str] = None,
    subspace: int = 0,
) -> int:
    inter = load_interactions(interactions_path)
    train, heldout, seen = split_leave_k_out(inter, k=2, seed=config.seed)
    log.info(
        "MF train: %d users x %d items, solver=%s dim=%d mesh=%s",
        inter.num_users, inter.num_items, solver, config.embedding_dim,
        dict(mesh.shape) if mesh is not None else None,
    )
    if solver == "als":
        users, items = train_als(
            train, config, mesh=mesh, shard_tables=shard_tables,
            checkpoint_dir=checkpoint_dir, subspace=subspace,
        )
    else:
        users, items = train_sgd(
            train, config, num_steps=2000, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
        )
    metrics = evaluate_ranking(users, items, heldout, k=10, train_mask=seen)
    print(
        f"recall@10={metrics['recall@k']:.4f} ndcg@10={metrics['ndcg@k']:.4f} "
        f"({metrics['num_eval_users']} users)"
    )
    save_model(output, users, items, config)
    return 0
