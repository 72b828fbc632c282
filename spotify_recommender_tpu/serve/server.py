"""HTTP retrieval service.

The reference is batch-CLI only (one process per query, reloading the
catalog and re-initializing the device every time — reference
main.cpp:46-63).  This service keeps the Retriever device-resident and
serves queries over HTTP with zero per-request setup:

  GET  /healthz                          → {"status": "ok", ...}
  GET  /recommend?song=<name>&n=10       → ranked results by name
  GET  /recommend?id=<track_id>&n=10     → ranked results by track id
  GET  /song/<row>                       → one catalog entry
  POST /retrieve {"queries": [[...]], "k": 10}
                                         → batched raw-vector retrieval
  POST /reload {"catalog": "path.npz"}   → hot-swap the catalog

Concurrency model: JAX dispatch is thread-safe, so requests run without a
global lock.  Single-query /recommend traffic additionally flows through a
**micro-batch coalescer** — concurrent requests arriving within a short
window are stacked into ONE kernel batch (the kernel is batch-optimized;
B=1 dispatches waste it), then results are sliced back per request.

stdlib http.server (threaded) keeps the framework dependency-free.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from spotify_recommender_tpu.core.config import RetrievalConfig
from spotify_recommender_tpu.core.logging import get_logger

log = get_logger(__name__)

# POST bodies larger than this are rejected with 413 (a (B, F) query
# payload at the default cap is ~64 MB of JSON — far beyond any sane batch).
MAX_BODY_BYTES = 64 * 1024 * 1024


class ServiceOverloaded(RuntimeError):
    """Raised by the coalescer when its pending queue is full — mapped to
    HTTP 429 so clients shed load early instead of queueing toward the
    submit timeout."""


class BatchCoalescer:
    """Stacks concurrent single-query retrievals into one kernel batch.

    Callers block in `submit` until the dispatcher thread has run their
    batch; the dispatcher waits `window_ms` after the first enqueue so
    concurrent requests coalesce, then dispatches up to `max_batch` at
    once.  Per-request k values are served from one top-max(k) retrieval.
    """

    def __init__(
        self,
        retrieve_fn,             # (queries (B,F), k, exclude (B,)) -> (s, r)
        max_batch: int = 256,
        window_ms: float = 2.0,
        max_queue: int = 2048,
    ) -> None:
        self._retrieve = retrieve_fn
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        # backpressure: a burst past device throughput must be shed with
        # 429s at enqueue time, not discovered via the 300 s submit timeout
        self.max_queue = max_queue
        self._cv = threading.Condition()
        self._pending: list = []
        self._stop = False
        self.stats = {
            "batches": 0, "batched_requests": 0, "max_batch_size": 0,
            "rejected": 0,
        }
        self._thread = threading.Thread(
            target=self._run, name="batch-coalescer", daemon=True
        )
        self._thread.start()

    def submit(
        self, query: np.ndarray, exclude_row: int, k: int,
        timeout_s: float = 300.0,
    ):
        """Enqueue one query; blocks until its batch has run.
        Returns (scores (k,), rows (k,)) or raises the batch's error.
        A wedged device raises TimeoutError instead of hanging the HTTP
        worker thread forever."""
        slot: dict = {}
        ev = threading.Event()
        with self._cv:
            if self._stop:
                raise RuntimeError("coalescer closed")
            if len(self._pending) >= self.max_queue:
                self.stats["rejected"] += 1
                raise ServiceOverloaded(
                    f"pending queue full ({self.max_queue} requests)"
                )
            self._pending.append((query, exclude_row, k, slot, ev))
            self._cv.notify()
        if not ev.wait(timeout=timeout_s):
            raise TimeoutError(
                f"retrieval batch did not complete within {timeout_s}s"
            )
        if "error" in slot:
            raise slot["error"]
        return slot["scores"], slot["rows"]

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop and not self._pending:
                    return
            # coalescing window: let concurrent requests pile up
            if self.window_s > 0:
                time.sleep(self.window_s)
            with self._cv:
                batch = self._pending[: self.max_batch]
                del self._pending[: self.max_batch]
            if not batch:
                continue
            # pad to a power-of-two bucket IN NUMPY: the device then only
            # ever sees a handful of batch shapes (each distinct raw size
            # would otherwise compile its own executable)
            nb = len(batch)
            bb = max(8, 1 << (nb - 1).bit_length())
            f = batch[0][0].shape[0]
            # pad rows DUPLICATE the first query (not zeros), so padding
            # behaves like ordinary traffic
            queries = np.tile(batch[0][0].astype(np.float32), (bb, 1))
            excl = np.full(bb, -1, np.int32)
            for i, entry in enumerate(batch):
                queries[i] = entry[0]
                excl[i] = entry[1]
            kmax = max(b[2] for b in batch)
            try:
                scores, rows = self._retrieve(queries, kmax, excl)
                scores = np.asarray(scores)
                rows = np.asarray(rows)
                for i, (_, _, k, slot, ev) in enumerate(batch):
                    slot["scores"] = scores[i, :k]
                    slot["rows"] = rows[i, :k]
                    ev.set()
            except Exception as e:  # deliver the failure to every waiter
                for _, _, _, slot, ev in batch:
                    slot["error"] = e
                    ev.set()
            self.stats["batches"] += 1
            self.stats["batched_requests"] += len(batch)
            self.stats["max_batch_size"] = max(
                self.stats["max_batch_size"], len(batch)
            )

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)


class RecommenderService:
    """Catalog + retriever + coalescer; the request-handling core,
    separated from HTTP for testability.

    JAX dispatches are NOT serialized by a lock — the runtime is
    thread-safe and the device queue orders execution; the lock guards
    only stats and catalog swaps."""

    def __init__(
        self,
        catalog,
        config: Optional[RetrievalConfig] = None,
        coalesce_window_ms: float = 2.0,
        max_batch: int = 256,
        max_queue: int = 2048,
    ):
        from spotify_recommender_tpu.retrieval.retriever import Retriever

        self._config = config
        self.retriever = Retriever(catalog, config)
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "errors": 0, "total_latency_s": 0.0}
        # bounded latency ring for p50/p99 (last 8192 requests)
        self._lat_ring = np.zeros(8192, np.float64)
        self._lat_n = 0
        self.coalescer = BatchCoalescer(
            self._retrieve_batch,
            max_batch=max_batch,
            window_ms=coalesce_window_ms,
            max_queue=max_queue,
        )

    def warmup(self, k: int = 10, max_batch: Optional[int] = None) -> float:
        """Compile every coalescer batch-size bucket before traffic lands.

        The first compile of each batch size would otherwise be paid by
        the first unlucky requests of that size; serve() calls this at
        startup.  Returns seconds spent."""
        t0 = time.perf_counter()
        feats = self.retriever.catalog.features
        cap = min(max_batch or self.coalescer.max_batch, 256)
        b = 8
        while True:
            q = np.asarray(feats[:1], np.float32).repeat(min(b, cap), axis=0)
            self.retriever.retrieve_host(
                q, k=k, exclude_rows=np.full(len(q), -1, np.int32)
            )
            if b >= cap:
                break
            b *= 2
        dt = time.perf_counter() - t0
        log.info("serve warmup: buckets up to %d compiled in %.1fs", cap, dt)
        return dt

    def _retrieve_batch(self, queries, k, exclude_rows):
        # the retriever reference is re-read per call → hot reload swaps in
        return self.retriever.retrieve_host(
            queries, k=k, exclude_rows=exclude_rows
        )

    def _record(self, t0: float, ok: bool) -> None:
        dt = time.perf_counter() - t0
        with self._lock:
            self._stats["requests"] += 1
            if not ok:
                self._stats["errors"] += 1
            self._stats["total_latency_s"] += dt
            self._lat_ring[self._lat_n % len(self._lat_ring)] = dt
            self._lat_n += 1

    def reset_latency_stats(self) -> None:
        """Drop recorded latencies/counters (e.g. after a warm-up round,
        so percentiles describe only the measured traffic)."""
        with self._lock:
            self._stats = {
                "requests": 0, "errors": 0, "total_latency_s": 0.0
            }
            self._lat_n = 0

    def latency_percentiles(self) -> dict:
        """p50/p95/p99 over the last <=8192 recorded request latencies."""
        with self._lock:
            n = min(self._lat_n, len(self._lat_ring))
            if n == 0:
                return {}
            window = self._lat_ring[:n].copy()
        p50, p95, p99 = np.percentile(window, [50, 95, 99])
        return {
            "p50_latency_ms": round(1e3 * float(p50), 3),
            "p95_latency_ms": round(1e3 * float(p95), 3),
            "p99_latency_ms": round(1e3 * float(p99), 3),
        }

    def metrics(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        n = max(1, s["requests"])
        out = {
            "requests": s["requests"],
            "errors": s["errors"],
            "mean_latency_ms": round(1e3 * s["total_latency_s"] / n, 3),
            **self.latency_percentiles(),
            "num_items": len(self.retriever.catalog),
            "backend": self.retriever.backend,
            "coalescer": dict(self.coalescer.stats),
        }
        return out

    def recommend(self, query: str, by_id: bool, k: int) -> dict:
        t0 = time.perf_counter()
        retriever = self.retriever
        try:
            if by_id:
                row = retriever.index.find_by_track_id(query)
                if row is None:
                    raise KeyError(f"Song with track_id '{query}' not found")
            else:
                row = retriever.index.find_by_name(query)
                if row is None:
                    raise KeyError(f"Song with name '{query}' not found")
            kk = min(k, len(retriever.catalog) - 1)
            scores, rows = self.coalescer.submit(
                np.asarray(retriever.catalog.features[row], np.float32),
                row,
                kk,
            )
            recs = retriever._materialize(rows, scores)
        except ServiceOverloaded as e:
            self._record(t0, ok=False)
            return {"error": str(e), "status": 429}
        except (KeyError, IndexError) as e:
            self._record(t0, ok=False)
            return {"error": e.args[0] if e.args else str(e), "status": 404}
        self._record(t0, ok=True)
        return {
            "query": dataclasses.asdict(retriever.lookup(row)),
            "results": [dataclasses.asdict(r) for r in recs],
            "status": 200,
        }

    def song(self, row: int) -> dict:
        if row < 0 or row >= len(self.retriever.catalog):
            return {"error": f"row {row} out of range", "status": 404}
        return {"song": dataclasses.asdict(self.retriever.lookup(row)), "status": 200}

    def retrieve(self, queries, k: int) -> dict:
        t0 = time.perf_counter()
        retriever = self.retriever
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != retriever.catalog.features.shape[1]:
            self._record(t0, ok=False)
            return {
                "error": f"queries must be (B, {retriever.catalog.features.shape[1]})",
                "status": 400,
            }
        # already-batched traffic dispatches directly (no lock: JAX is
        # thread-safe; the device queue serializes execution)
        scores, rows = retriever.retrieve(q, k=k)
        self._record(t0, ok=True)
        return {
            "scores": np.asarray(scores).tolist(),
            "rows": np.asarray(rows).tolist(),
            "status": 200,
        }

    def reload(self, catalog_path: str) -> dict:
        """Hot-swap the catalog: build the new retriever off to the side,
        then atomically replace the reference (in-flight requests finish
        on the old one)."""
        from spotify_recommender_tpu.retrieval.retriever import Retriever

        try:
            cat = _load_catalog(catalog_path)
            new_retriever = Retriever(cat, self._config)
        except Exception as e:
            return {"error": f"reload failed: {e}", "status": 400}
        with self._lock:
            self.retriever = new_retriever
        log.info("catalog hot-reloaded: %s (%d items)", catalog_path, len(cat))
        return {
            "status": 200,
            "reloaded": catalog_path,
            "num_items": len(cat),
        }

    def health(self) -> dict:
        return {
            "status": "ok",
            "num_items": len(self.retriever.catalog),
            "backend": self.retriever.backend,
        }

    def close(self) -> None:
        self.coalescer.close()


def _load_catalog(path: str):
    from spotify_recommender_tpu.data.catalog import Catalog

    if path.endswith(".bin"):
        return Catalog.load_reference_binary(path)
    return Catalog.load(path)


def _make_handler(service: RecommenderService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, payload: dict) -> None:
            code = payload.get("status", 200)
            if isinstance(code, int):
                payload.pop("status", None)
            else:
                code = 200  # payload-level status strings (e.g. healthz "ok")
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            url = urlparse(self.path)
            qs = parse_qs(url.query)
            try:
                if url.path == "/healthz":
                    self._send(self.server_service.health())
                elif url.path == "/metrics":
                    self._send(self.server_service.metrics())
                elif url.path == "/recommend":
                    try:
                        k = int(qs.get("n", ["10"])[0])
                    except ValueError:
                        self._send({"error": "n must be an integer", "status": 400})
                        return
                    if k <= 0:
                        self._send({"error": "n must be positive", "status": 400})
                    elif "id" in qs:
                        self._send(
                            self.server_service.recommend(qs["id"][0], True, k)
                        )
                    elif "song" in qs:
                        self._send(
                            self.server_service.recommend(qs["song"][0], False, k)
                        )
                    else:
                        self._send({"error": "need ?song= or ?id=", "status": 400})
                elif url.path.startswith("/song/"):
                    try:
                        row = int(url.path[6:])
                    except ValueError:
                        self._send(
                            {"error": "song row must be an integer", "status": 400}
                        )
                        return
                    self._send(self.server_service.song(row))
                else:
                    self._send({"error": "not found", "status": 404})
            except Exception as e:  # pragma: no cover
                self._send({"error": str(e), "status": 500})

        def do_POST(self) -> None:  # noqa: N802
            url = urlparse(self.path)
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    self._send(
                        {"error": f"body exceeds {MAX_BODY_BYTES} bytes",
                         "status": 413}
                    )
                    return
                body = json.loads(self.rfile.read(n) or b"{}")
                if url.path == "/retrieve":
                    self._send(
                        self.server_service.retrieve(
                            body.get("queries", []), int(body.get("k", 10))
                        )
                    )
                elif url.path == "/reload":
                    path = body.get("catalog")
                    if not path:
                        self._send(
                            {"error": "need {'catalog': path}", "status": 400}
                        )
                    else:
                        self._send(self.server_service.reload(str(path)))
                else:
                    self._send({"error": "not found", "status": 404})
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._send({"error": f"bad request: {e}", "status": 400})

        def log_message(self, fmt, *args):  # route to our logger
            log.info("http %s", fmt % args)

    return Handler


def make_server(
    catalog, host: str = "127.0.0.1", port: int = 8000,
    config: Optional[RetrievalConfig] = None,
    coalesce_window_ms: float = 2.0,
) -> ThreadingHTTPServer:
    service = RecommenderService(
        catalog, config, coalesce_window_ms=coalesce_window_ms
    )
    handler = _make_handler(service)
    srv = ThreadingHTTPServer((host, port), handler)
    srv.server_service = service  # type: ignore[attr-defined]
    handler.server_service = service  # type: ignore[attr-defined]
    return srv


def serve(catalog_path: str, host: str = "127.0.0.1", port: int = 8000) -> int:
    cat = _load_catalog(catalog_path)
    srv = make_server(cat, host, port)
    srv.server_service.warmup()  # type: ignore[attr-defined]
    log.info("serving %d items on http://%s:%d", len(cat), host, port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_service.close()  # type: ignore[attr-defined]
        srv.server_close()
    return 0
