"""Host-streaming exact retrieval for catalogs beyond device memory.

Completes the catalog-length-scaling ladder (SURVEY §5 "long-context
analog"): the device-resident catalog covers one card, catalog sharding
covers a mesh — and this covers catalogs that do not fit the WHOLE MESH's
memory: feature rows stay on host (ideally the memory-mapped catalog
directory format, so they need not fit host RAM either) and stream through
the device in fixed-size windows, with the running top-k merged on device.

Each window is scored by the path retrieval/path.choose_path picks for a
(window, F) catalog, and the merge preserves the lowest-index tie rule
(ascending windows + `merge_topk` favoring the earlier list) — results
equal `ops/similarity.exact_topk`.

Throughput is bound by the host-device link by construction (every byte
crosses it once per batch), so this is the capacity tier, not the speed
tier; batch queries to amortize the stream.  Windows are double-buffered:
a background thread stages and `device_put`s window i+1 while the device
scores window i (JAX dispatch is async, so the host thread never waits on
compute).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spotify_recommender_tpu.core.config import RetrievalConfig
from spotify_recommender_tpu.core.logging import get_logger
from spotify_recommender_tpu.ops.similarity import NEG_INF, merge_topk
from spotify_recommender_tpu.retrieval.path import (
    KERNEL,
    choose_path,
    score_topk,
)

log = get_logger(__name__)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@partial(jax.jit, static_argnames=("k", "eps", "path", "interpret"))
def _window_merge(
    best_s: jnp.ndarray,     # (B, k) running top-k scores
    best_i: jnp.ndarray,     # (B, k) running global indices
    queries: jnp.ndarray,    # (B, F)
    window: jnp.ndarray,     # (W, F) this window's feature rows
    norms: jnp.ndarray,      # (W,)
    offset: jnp.ndarray,     # () int32 global index of the window start
    valid: jnp.ndarray,      # () int32 valid rows in this window
    excl: jnp.ndarray,       # (B,) excluded global rows (-1 = none)
    *,
    k: int,
    eps: float,
    path: str,
    interpret: bool,
):
    # exclusions are global; the window sees window-local rows
    excl_local = jnp.where(
        (excl >= offset) & (excl < offset + valid), excl - offset, -1
    )
    w_s, w_i = score_topk(
        queries, window, norms, excl_local, valid,
        k=k, eps=eps, path=path, interpret=interpret,
    )
    # keep the -1 sentinel of empty slots out of the global frame
    return merge_topk(
        best_s, best_i, w_s, jnp.where(w_i < 0, -1, offset + w_i), k
    )


class StreamingRetriever:
    """Exact top-k over a host-resident (possibly memory-mapped) catalog.

    `features` may be any (N, F) array-like supporting slicing — an
    np.memmap from `Catalog.load_dir` streams windows straight off disk
    through page cache to the device, so neither HBM nor host RAM bounds
    the catalog size.
    """

    def __init__(
        self,
        features,                       # (N, F) host array / memmap
        norms: Optional[np.ndarray] = None,
        config: Optional[RetrievalConfig] = None,
        window: int = 1 << 20,          # rows per device slab (~48 MB @ F=12)
        prefetch: bool = True,
        interpret: bool = False,        # tests: the kernel, interpreted
    ) -> None:
        self.config = config or RetrievalConfig()
        self.features = features
        n, f = features.shape
        self.num_items = n
        self.feature_dim = f
        self.window = _round_up(min(window, max(1, n)), 128)
        self.interpret = interpret
        self.prefetch = prefetch
        if norms is None:
            # windowed norm computation: never materialize all rows
            norms = np.empty(n, np.float32)
            for s in range(0, n, self.window):
                e = min(s + self.window, n)
                norms[s:e] = np.linalg.norm(
                    np.asarray(features[s:e], np.float32), axis=1
                )
        self.norms = np.asarray(norms, np.float32)
        log.info(
            "streaming retriever: %d items x %d dims, window %d rows",
            n, f, self.window,
        )

    def __call__(
        self,
        queries: jnp.ndarray,
        k: int,
        exclude_rows: Optional[jnp.ndarray] = None,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
        b, f = queries.shape
        if f != self.feature_dim:
            raise ValueError(f"query dim {f} != catalog dim {self.feature_dim}")
        excl = (
            jnp.full((b,), -1, jnp.int32)
            if exclude_rows is None
            else jnp.asarray(exclude_rows, jnp.int32)
        )
        best_s = jnp.full((b, k), NEG_INF, jnp.float32)
        best_i = jnp.full((b, k), -1, jnp.int32)
        w = self.window
        starts = list(range(0, self.num_items, w))
        path = KERNEL if self.interpret else choose_path(
            jax.default_backend(), w, f, b, k,
            use_kernel=self.config.use_pallas,
        )

        def stage(s: int):
            """Host-side staging + async H2D upload of one window (runs on
            the prefetch thread, overlapped with the device scoring the
            previous window)."""
            e = min(s + w, self.num_items)
            slab = np.zeros((w, f), np.float32)
            slab[: e - s] = np.asarray(self.features[s:e], np.float32)
            nslab = np.zeros(w, np.float32)
            nslab[: e - s] = self.norms[s:e]
            return (
                jax.device_put(jnp.asarray(slab)),
                jax.device_put(jnp.asarray(nslab)),
                s, e,
            )

        pool = ThreadPoolExecutor(1) if self.prefetch and len(starts) > 1 \
            else None
        try:
            fut = pool.submit(stage, starts[0]) if pool else None
            for i, s0 in enumerate(starts):
                slab, nslab, s, e = fut.result() if pool else stage(s0)
                if pool and i + 1 < len(starts):
                    fut = pool.submit(stage, starts[i + 1])
                best_s, best_i = _window_merge(
                    best_s, best_i, queries, slab, nslab,
                    jnp.int32(s), jnp.int32(e - s), excl,
                    k=k, eps=self.config.eps, path=path,
                    interpret=self.interpret,
                )
        finally:
            if pool:
                pool.shutdown(wait=False)
        return best_s, best_i

    # reference-API sugar mirroring Retriever.retrieve
    def retrieve(self, queries, k=None, exclude_rows=None):
        k = self.config.top_k if k is None else k
        return self(queries, k, exclude_rows)
