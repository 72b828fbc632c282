"""Benchmark harness: queries/sec/chip for exact top-k retrieval.

North-star metric (BASELINE.json): queries/sec/chip for exact top-10 over a
1M-item catalog.  The reference's own headline number is ~3.5-5 ms per
single query over a 100K-item catalog on an RTX 3060 (reference
ARCHITECTURE.md:242-247, PROJECT_SUMMARY.md:130-138) ≈ 250 queries/sec —
that serves as `vs_baseline`'s denominator even though our workload is 10x
the catalog (1M items), so vs_baseline understates the true speedup per
scored item by ~10x.

Timings end in a host readback of the result (honest device timings,
SURVEY.md §5), and every result names the device it ran on.
"""

from __future__ import annotations

import dataclasses
import json
import time

import jax
import numpy as np

from spotify_recommender_tpu.core.logging import get_logger

log = get_logger(__name__)

# Reference headline: ~4 ms/query end-to-end at 100K items => ~250 qps.
REFERENCE_QPS = 250.0


@dataclasses.dataclass
class BenchResult:
    metric: str
    value: float
    unit: str
    vs_baseline: float
    details: dict


def _make_inputs(num_items: int, num_queries: int, dim: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    # bounded [0,1] features like the normalized catalog
    feats = rng.random((num_items, dim), dtype=np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    q_rows = rng.integers(0, num_items, size=num_queries)
    queries = feats[q_rows]
    return feats, norms, queries, q_rows.astype(np.int32)


def device_info() -> dict:
    """The device a result was measured on, as JAX reports it."""
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
    }


def run_benchmark(
    num_items: int = 1_000_000,
    num_queries: int = 1024,
    feature_dim: int = 12,
    k: int = 10,
    backend: str = "auto",
    warmup: int = 2,
    iters: int = 10,
    seed: int = 0,
    reps: int = 1,
    also_b1: bool = False,
) -> BenchResult:
    """Exact top-k throughput on the path retrieval/path.choose_path
    picks (`backend="auto"`) or on XLA alone (`backend="xla"`)."""
    from spotify_recommender_tpu.core.config import COSINE_EPS
    from spotify_recommender_tpu.retrieval.path import (
        choose_path,
        score_topk,
    )

    if backend not in ("auto", "xla"):
        raise ValueError(f"unknown benchmark backend {backend!r}")
    feats, norms, queries, q_rows = _make_inputs(
        num_items, num_queries, feature_dim, seed
    )
    dev_feats = jax.device_put(feats)
    dev_norms = jax.device_put(norms)
    dev_queries = jax.device_put(queries)
    dev_excl = jax.device_put(q_rows)
    valid = jax.device_put(np.int32(num_items))

    info = device_info()

    def path_for(b: int) -> str:
        return choose_path(
            info["platform"], num_items, feature_dim, b, k,
            use_kernel=backend == "auto",
        )

    chosen = path_for(num_queries)

    def step(q, excl):
        return score_topk(
            q, dev_feats, dev_norms, excl, valid,
            k=k, eps=COSINE_EPS, path=path_for(q.shape[0]),
        )

    def chain(n: int, q0, excl) -> float:
        """n chained retrievals (each batch depends on the previous
        output) fenced by a host readback."""
        t0 = time.perf_counter()
        cur = q0
        for _ in range(n):
            scores, rows = step(cur, excl)
            cur = q0 + 0.0 * scores[0, 0]
        float(scores[0, 0])
        return (time.perf_counter() - t0) / n

    # Warmup compiles BOTH the retrieval step and the chain-dependency op.
    t0 = time.perf_counter()
    chain(max(1, warmup), dev_queries, dev_excl)
    compile_time = time.perf_counter() - t0

    t_med = min(
        chain(iters, dev_queries, dev_excl) for _ in range(max(1, reps))
    )
    qps = num_queries / t_med

    # the score pass must stream the catalog once
    bytes_streamed = num_items * feature_dim * 4 + num_items * 4
    gbps = bytes_streamed / t_med / 1e9

    details = {
        "backend": chosen,
        **info,
        "num_items": num_items,
        "num_queries": num_queries,
        "feature_dim": feature_dim,
        "k": k,
        "exact": True,
        "batch_latency_ms": round(t_med * 1e3, 3),
        "effective_catalog_stream_GBps": round(gbps, 1),
        "compile_plus_warmup_s": round(compile_time, 2),
    }
    if also_b1:
        # single-query latency on the same device-resident catalog
        q1, e1 = dev_queries[:1], dev_excl[:1]
        chain(1, q1, e1)
        t_b1 = min(chain(8, q1, e1) for _ in range(max(1, reps)))
        details["b1_backend"] = path_for(1)
        details["b1_latency_ms"] = round(t_b1 * 1e3, 3)
        details["b1_stream_GBps"] = round(bytes_streamed / t_b1 / 1e9, 1)
    result = BenchResult(
        metric=f"queries/sec/chip exact top-{k} over {num_items} items",
        value=round(qps, 1),
        unit="queries/sec",
        vs_baseline=round(qps / REFERENCE_QPS, 2),
        details=details,
    )
    log.info("benchmark: %s", result)
    return result


def run_quality_row(seed: int = 0) -> dict:
    """Training-quality metrics (BASELINE 'recall@10 (MF path)'): fixed-seed
    ALS recall@10/NDCG@10 on low-rank synthetic implicit feedback, plus a
    two-tower co-listen hit rate through the same MIPS retrieval stack.
    Small fixed workload: the row is a regression tripwire (a training or
    eval regression shows up as a recall drop), not a throughput claim."""
    from spotify_recommender_tpu.core.config import MFConfig, TwoTowerConfig
    from spotify_recommender_tpu.models import mf, two_tower

    out: dict = {}
    inter, _, _ = mf.synthetic_interactions(
        num_users=2000, num_items=1000, latent_dim=8, seed=seed
    )
    train_i, held_idx, held_mask, seen_idx, seen_mask = (
        mf.split_leave_k_out_arrays(inter, k=1, seed=seed)
    )
    users, items = mf.train_als(
        train_i,
        MFConfig(embedding_dim=16, num_iterations=6, reg=0.05, alpha=10.0,
                 seed=seed),
    )
    eligible = np.nonzero(held_mask.any(axis=1))[0]
    m = mf.evaluate_ranking_arrays(
        users, items, eligible, held_idx[eligible], held_mask[eligible],
        k=10, seen_idx=seen_idx[eligible], seen_mask=seen_mask[eligible],
    )
    out["mf_als_recall_at_10"] = round(m["recall@k"], 4)
    out["mf_als_ndcg_at_10"] = round(m["ndcg@k"], 4)

    # two-tower on the same co-listen signal: item features are a noisy
    # low-dim projection so the towers have something to learn from
    rng = np.random.default_rng(seed)
    feats = (items @ rng.standard_normal((items.shape[1], 12)) / 4.0
             ).astype(np.float32) + 0.05 * rng.standard_normal(
        (items.shape[0], 12)
    ).astype(np.float32)
    # Tripwire: 2000 steps, T=1.0, raw-magnitude item tower.  The 12-d
    # feature inputs cap what the towers can learn (raw-feature kNN sets
    # the ceiling); a training/eval regression shows as a drop toward the
    # 0.01 random floor.
    cfg = TwoTowerConfig(
        embedding_dim=16, hidden_dims=(32,), batch_size=256,
        num_steps=2000, learning_rate=3e-3, temperature=1.0,
        normalize_items=False, seed=seed,
    )
    res = two_tower.train(
        feats, np.zeros(len(feats), np.int32), cfg,
        pair_fn=two_tower.colisten_pair_fn(train_i, feats, rng),
    )
    tm = two_tower.evaluate_colisten(res.params, cfg, feats, inter, k=10,
                                     seed=seed)
    out["two_tower_recall_at_10"] = round(tm["recall@k"], 4)
    out["two_tower_ndcg_at_10"] = round(tm["ndcg@k"], 4)
    return out


def run_serve_row(
    num_items: int = 1_000_000,
    n_clients: int = 32,
    reqs_each: int = 10,
    max_queue: int = 64,
    seed: int = 0,
) -> dict:
    """Serving p50/p95/p99 + aggregate req/s through the coalescer, plus a
    backpressure burst past queue capacity (exercising the 429 path).
    Drives RecommenderService directly (the HTTP layer adds socket cost,
    not device cost)."""
    import threading

    from spotify_recommender_tpu.core.config import RetrievalConfig
    from spotify_recommender_tpu.data.catalog import Catalog
    from spotify_recommender_tpu.serve.server import (
        RecommenderService, ServiceOverloaded,
    )

    rng = np.random.default_rng(seed)
    feats = rng.random((num_items, 12), dtype=np.float32)
    cat = Catalog(
        features=feats,
        norms=np.linalg.norm(feats, axis=1).astype(np.float32),
        track_ids=np.asarray(
            [f"tid{i:08d}" for i in range(num_items)], object
        ),
        track_names=np.asarray(
            [f"Song {i}" for i in range(num_items)], object
        ),
        artists=np.asarray(
            [f"Artist {i % 997}" for i in range(num_items)], object
        ),
        genre_ids=np.zeros(num_items, np.int32),
        genre_names=["all"],
        min_vals=np.zeros(11, np.float32),
        max_vals=np.ones(11, np.float32),
    )
    svc = RecommenderService(
        cat, RetrievalConfig(), coalesce_window_ms=2.0, max_queue=max_queue
    )
    try:
        svc.warmup(max_batch=32)
        ids = [f"tid{i:08d}"
               for i in rng.integers(0, num_items, n_clients * reqs_each)]
        errors: list = []

        def client(c: int):
            for j in range(reqs_each):
                r = svc.recommend(ids[c * reqs_each + j], by_id=True, k=10)
                if "error" in r:
                    errors.append(r)

        def run_round() -> float:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(n_clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return time.perf_counter() - t0

        run_round()                       # warm each coalesced bucket
        errors.clear()
        # percentiles must describe the SAME sample as serve_req_per_s:
        # drop the warm round's latencies before the measured round
        svc.reset_latency_stats()
        dt = run_round()
        metrics = svc.metrics()
        ok_reqs = n_clients * reqs_each - len(errors)
        out = {
            # throughput counts SUCCESSFUL responses only — shed (429)
            # requests are recorded separately, never as capacity
            "serve_req_per_s": round(ok_reqs / dt, 1),
            "serve_p50_ms": metrics.get("p50_latency_ms"),
            "serve_p95_ms": metrics.get("p95_latency_ms"),
            "serve_p99_ms": metrics.get("p99_latency_ms"),
            "serve_errors": len(errors),
        }

        # burst past capacity: max_queue+64 simultaneous submits while the
        # dispatcher is busy -> the overflow must be shed as 429s
        burst_n = max_queue + 64
        rejected: list = []
        barrier = threading.Barrier(burst_n)

        def burst_client(c: int):
            barrier.wait()
            try:
                svc.coalescer.submit(feats[c % num_items], -1, 10)
            except ServiceOverloaded:
                rejected.append(c)

        threads = [threading.Thread(target=burst_client, args=(c,))
                   for c in range(burst_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["serve_burst_requests"] = burst_n
        out["serve_burst_rejected_429"] = len(rejected)
        return out
    finally:
        svc.close()


def run_streaming_row(
    num_items: int = 4_000_000,
    num_queries: int = 256,
    window: int = 1 << 20,
    seed: int = 0,
) -> dict:
    """Host-streaming capacity tier: exact top-k with the catalog resident
    on HOST memory, streamed through the device in windows (the rung past
    the reference's GPU-memory wall, reference ARCHITECTURE.md:305-309).

    The recorded GB/s is bound by the HOST-DEVICE LINK by construction
    (`hostlink_GBps` is the measured raw link rate, for context).  The
    row's regression value is that the tier RUNS end-to-end and its
    overlap/merge cost stays near the measured link floor
    (`streaming_link_efficiency`)."""
    from spotify_recommender_tpu.retrieval.streaming_retriever import (
        StreamingRetriever,
    )

    rng = np.random.default_rng(seed)
    feats = rng.random((num_items, 12), dtype=np.float32)
    queries = feats[rng.integers(0, num_items, num_queries)]

    # measured raw link rate for the efficiency denominator
    jax.block_until_ready(jax.device_put(np.asarray(feats[:window])))
    t0 = time.perf_counter()
    jax.block_until_ready(jax.device_put(np.asarray(feats[:window])))
    link_gbps = feats[:window].nbytes / (time.perf_counter() - t0) / 1e9

    sr = StreamingRetriever(feats, window=window)
    dq = jax.device_put(queries)
    jax.block_until_ready(sr(dq, 10))            # compile + first pass
    t0 = time.perf_counter()
    s, r = sr(dq, 10)
    jax.block_until_ready((s, r))
    dt = time.perf_counter() - t0
    bytes_streamed = num_items * 12 * 4
    gbps = bytes_streamed / dt / 1e9
    return {
        "streaming_items": num_items,
        "streaming_batch": num_queries,
        "streaming_qps": round(num_queries / dt, 1),
        "streaming_GBps": round(gbps, 3),
        "hostlink_GBps": round(link_gbps, 3),
        "streaming_link_efficiency": round(gbps / max(link_gbps, 1e-9), 2),
    }


def run_benchmark_suite(time_budget_s: float = 420.0) -> BenchResult:
    """Headline 1M exact row plus auxiliary rows (10M exact batch and
    single-query, 64-dim learned-embedding catalog), training-quality
    regression rows (ALS recall@10/NDCG@10, two-tower co-listen), a
    serving row (p50/p95/p99, req/s, 429 backpressure), and the
    host-streaming capacity tier in the details.

    The suite watches a wall-clock budget and SKIPS the remaining
    auxiliary rows past it; a row that fails fails the suite."""
    headline = run_benchmark(
        num_items=1_000_000, num_queries=1024, feature_dim=12, k=10,
        reps=3,
    )
    t_start = time.perf_counter()
    # emit the headline IMMEDIATELY: the enriched line printed at the end
    # supersedes it
    print(to_json_line(headline), flush=True)
    extras = {}

    def budget_left(tag: str, limit: float = 0.0) -> bool:
        used = time.perf_counter() - t_start
        if used > (limit or time_budget_s):
            log.warning("bench budget used (%.0fs); skipping %s", used, tag)
            extras.setdefault("skipped_rows", []).append(tag)
            return False
        return True

    if budget_left("10M", 0.5 * time_budget_s):
        r10m = run_benchmark(
            num_items=10_000_000, num_queries=1024, feature_dim=12,
            k=10, warmup=1, iters=4, also_b1=True,
        )
        extras["exact_10M_qps"] = r10m.value
        extras["exact_10M_batch_ms"] = r10m.details["batch_latency_ms"]
        extras["exact_10M_stream_GBps"] = r10m.details[
            "effective_catalog_stream_GBps"
        ]
        extras["exact_10M_B1_latency_ms"] = r10m.details.get("b1_latency_ms")
        extras["exact_10M_B1_stream_GBps"] = r10m.details.get(
            "b1_stream_GBps"
        )
    if budget_left("quality", 0.55 * time_budget_s):
        extras.update(run_quality_row())
    if budget_left("serve", 0.7 * time_budget_s):
        extras.update(run_serve_row())
    if budget_left("streaming", 0.8 * time_budget_s):
        extras.update(run_streaming_row())
    if budget_left("64dim", 0.9 * time_budget_s):
        r64 = run_benchmark(
            num_items=1_000_000, num_queries=1024, feature_dim=64,
            k=10, warmup=1, iters=6,
        )
        extras["exact_1M_64dim_qps"] = r64.value
    headline.details.update(extras)
    return headline


def to_json_line(r: BenchResult) -> str:
    return json.dumps(
        {
            "metric": r.metric,
            "value": r.value,
            "unit": r.unit,
            "vs_baseline": r.vs_baseline,
            **{"details": r.details},
        }
    )
