#!/usr/bin/env python
"""Prove on one NVIDIA GPU that the system's main paths run and are right.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # only the 4-card mesh path

Phases, in order (one process; the card is opened once, by JAX):

1. device: JAX must report a GPU; the card's name and power limit are
   printed as `nvidia-smi` gives them;
2. CLI at the reference's dataset scale: a synthetic Spotify-schema CSV of
   114,000 rows, `--preprocess`, then `--song <name> -n 10`;
3. retrieval against the oracle: default `Retriever`s at 1M x 12 B=1024,
   10M x 12 B=1024, 10M x 12 B=1 and 1M x 64 B=1024 (k=10), each compared
   with `similarity.exact_topk_chunked` at `Precision.HIGHEST` and timed
   beside the XLA-only path (`use_pallas=False`);
4. serving: `RecommenderService` on a 1M-item catalog behind the HTTP
   server (on a thread), checked against a direct `Retriever`;
5. training: 2 ALS iterations at 100k users x 20k items, d=64.

`--four-cards` runs a `ShardedCatalog` on a (data=1, catalog=4) mesh at
10M x 12 B=1024 against the one-card `Retriever`, and the sharded-table
ALS half-step against the one-card half-step.

Any failure raises, so the script exits non-zero and prints no result.
The last line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

import numpy as np

# Score tolerance against the oracle, and the index rule that goes with it.
# The kernel and cuBLAS sum the F products in different orders, and either
# differs from a CPU's order, so a score may move by a few ulps (~1e-7 near
# 1.0).  Two items whose oracle scores lie within the tolerance may then
# swap places; indices must agree everywhere else.
SCORE_TOL = 1e-6
K = 10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(tag, scores, rows, ref_scores, ref_rows) -> int:
    """Check (B, k) results against the oracle; return the count of
    positions excused by an oracle near-tie."""
    scores, rows = np.asarray(scores), np.asarray(rows)
    ref_scores, ref_rows = np.asarray(ref_scores), np.asarray(ref_rows)
    assert scores.shape == ref_scores.shape, (tag, scores.shape)
    assert np.isfinite(scores).all(), f"{tag}: non-finite scores"
    err = float(np.abs(scores - ref_scores).max())
    assert err <= SCORE_TOL, f"{tag}: max score error {err:.3g}"
    # a position is excused when the oracle's score there is within the
    # tolerance of a neighbour's
    gap_prev = np.full(ref_scores.shape, np.inf, np.float32)
    gap_next = np.full(ref_scores.shape, np.inf, np.float32)
    gap_prev[:, 1:] = ref_scores[:, :-1] - ref_scores[:, 1:]
    gap_next[:, :-1] = ref_scores[:, :-1] - ref_scores[:, 1:]
    near_tie = np.minimum(gap_prev, gap_next) <= SCORE_TOL
    bad = (rows != ref_rows) & ~near_tie
    assert not bad.any(), f"{tag}: {int(bad.sum())} index mismatches"
    return int(((rows != ref_rows) & near_tie).sum())


def synthetic_catalog(n: int, f: int, seed: int):
    from spotify_recommender_tpu.data.catalog import Catalog

    rng = np.random.default_rng(seed)
    feats = rng.random((n, f), dtype=np.float32)
    ids = np.char.add("t", np.arange(n).astype(np.str_))
    return Catalog(
        features=feats,
        norms=np.linalg.norm(feats, axis=1).astype(np.float32),
        track_ids=ids,
        track_names=np.char.add("Song ", np.arange(n).astype(np.str_)),
        artists=np.full(n, "Artist", dtype=object),
        genre_ids=np.zeros(n, np.int32),
        genre_names=["all"],
        min_vals=np.zeros(f - 1, np.float32),
        max_vals=np.ones(f - 1, np.float32),
    )


def timed(fn, reps: int = 5) -> float:
    """Median wall time of `fn()` in ms, each call ending in a readback."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def write_songs_csv(path: str, n_rows: int, seed: int = 0) -> None:
    """Spotify-schema CSV (reference DataManager.cpp:121-125 columns)."""
    rng = np.random.default_rng(seed)
    keys = np.array(["C", "C#", "D", "Eb", "E", "F", "F#", "G", "Ab", "A",
                     "Bb", "B"])
    vals = rng.random((n_rows, 8))
    loud = -60 + 60 * rng.random(n_rows)
    tempo = 40 + 180 * rng.random(n_rows)
    sym = keys[rng.integers(0, 12, n_rows)]
    num = rng.integers(0, 12, n_rows).astype(str)
    key = np.where(np.arange(n_rows) % 3 == 0, sym, num)
    mode = np.array(["Major", "Minor", "1", "0"])[rng.integers(0, 4, n_rows)]
    genre = rng.integers(0, 114, n_rows)
    lines = [
        "track_id,track_name,artists,album_name,danceability,energy,key,"
        "loudness,mode,speechiness,acousticness,instrumentalness,liveness,"
        "valence,tempo,track_genre"
    ]
    for i in range(n_rows):
        v = vals[i]
        lines.append(
            f"id{i:06d},Song {i},Artist {i % 37},Album {i % 11},"
            f"{v[0]:.4f},{v[1]:.4f},{key[i]},{loud[i]:.3f},{mode[i]},"
            f"{v[2]:.4f},{v[3]:.4f},{v[4]:.4f},{v[5]:.4f},"
            f"{v[6]:.4f},{tempo[i]:.3f},genre-{genre[i]}"
        )
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")


def phase_cli(card: str) -> None:
    from spotify_recommender_tpu import cli
    from spotify_recommender_tpu.data.catalog import Catalog
    from spotify_recommender_tpu.retrieval.retriever import Retriever

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        csv = os.path.join(td, "songs.csv")
        write_songs_csv(csv, 114_000)
        cwd = os.getcwd()
        os.chdir(td)
        try:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc_pre = cli.main(["--preprocess", csv])
                rc_rec = cli.main(["--song", "Song 4242", "-n", "10"])
            text = out.getvalue()
            assert rc_pre == 0 and rc_rec == 0, (rc_pre, rc_rec, text[-2000:])
            assert "Valid songs: 114000" in text, text[-2000:]
            assert "Recommendation complete" in text, text[-2000:]
            assert text.count("   Score:  ") == 10, text[-2000:]
            cat = Catalog.load("songs_catalog.npz")
        finally:
            os.chdir(cwd)
    dt = time.perf_counter() - t0
    # the CLI's ranking against a plain numpy transcription of the
    # reference's scorer (reference Recommender.cu:256-273)
    r = Retriever(cat)
    row = r.index.find_by_name("Song 4242")
    recs = r.recommend_by_index(row, K)
    feats = cat.features.astype(np.float32)
    q = feats[row]
    denom = np.linalg.norm(feats, axis=1) * np.linalg.norm(q)
    sims = np.where(denom > 1e-8, np.clip(feats @ q / denom, -1, 1), 0)
    sims[row] = -np.inf
    order = np.lexsort((np.arange(len(sims)), -sims))[:K]
    swaps = compare(
        "cli", [[x.score for x in recs]], [[x.row for x in recs]],
        sims[order][None].astype(np.float32), order[None],
    )
    log(f"phase 2 cli: preprocess + recommend over 114000 rows {dt:.2f} s, "
        f"path={r.backend}, near-tie swaps={swaps} ({card})")


def phase_retrieval(card: str) -> None:
    import jax
    import jax.numpy as jnp

    from spotify_recommender_tpu.core.config import RetrievalConfig
    from spotify_recommender_tpu.ops.similarity import exact_topk_chunked
    from spotify_recommender_tpu.retrieval.retriever import Retriever

    rng = np.random.default_rng(1)
    for n, f, batches in ((1_000_000, 12, (1024,)),
                          (10_000_000, 12, (1024, 1)),
                          (1_000_000, 64, (1024,))):
        t0 = time.perf_counter()
        cat = synthetic_catalog(n, f, seed=n + f)
        r = Retriever(cat)
        r_xla = Retriever(cat, RetrievalConfig(use_pallas=False))
        feats = jax.device_put(cat.features)
        norms = jax.device_put(cat.norms)
        log(f"phase 3 catalog {n}x{f} built in "
            f"{time.perf_counter() - t0:.2f} s ({card})")
        for b in batches:
            rows = rng.integers(0, len(cat), b).astype(np.int32)
            q = jnp.asarray(cat.features[rows])
            ex = jnp.asarray(rows)
            s, i = r.retrieve(q, K, ex)
            os_, oi = exact_topk_chunked(q, feats, norms, ex, k=K)
            swaps = compare(f"{n}x{f} B={b}", s, i, os_, oi)
            t_path = timed(lambda: r.retrieve(q, K, ex))
            t_xla = timed(lambda: r_xla.retrieve(q, K, ex))
            log(f"phase 3 retrieve {n}x{f} B={b} k={K}: "
                f"{r.path_for(b, K)} {t_path:.3f} ms, "
                f"{r_xla.path_for(b, K)} {t_xla:.3f} ms, "
                f"max |score err| {float(jnp.abs(s - os_).max()):.3g}, "
                f"near-tie swaps {swaps} ({card})")
        del r, r_xla, cat, feats, norms
        jax.clear_caches()


def phase_serving(card: str) -> None:
    from spotify_recommender_tpu.retrieval.retriever import Retriever
    from spotify_recommender_tpu.serve.server import make_server

    cat = synthetic_catalog(1_000_000, 12, seed=7)
    srv = make_server(cat, port=0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    direct = Retriever(cat)
    # straight to localhost: no proxy from the environment
    http = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        lat = []
        for row in (0, len(cat) // 8, len(cat) - 1):
            t0 = time.perf_counter()
            with http.open(
                f"{base}/recommend?song="
                + urllib.parse.quote(f"Song {row}") + f"&n={K}",
                timeout=300,
            ) as resp:
                got = json.loads(resp.read())
            lat.append(time.perf_counter() - t0)
            want = direct.recommend_by_index(row, K)
            compare(
                f"serve song {row}",
                [[x["score"] for x in got["results"]]],
                [[x["row"] for x in got["results"]]],
                [[x.score for x in want]], [[x.row for x in want]],
            )
        queries = cat.features[[5, 6, 7]].tolist()
        req = urllib.request.Request(
            f"{base}/retrieve",
            data=json.dumps({"queries": queries, "k": 5}).encode(),
            headers={"Content-Type": "application/json"},
        )
        t0 = time.perf_counter()
        with http.open(req, timeout=300) as resp:
            got = json.loads(resp.read())
        lat.append(time.perf_counter() - t0)
        ws, wi = direct.retrieve_host(np.asarray(queries, np.float32), k=5)
        compare("serve retrieve", got["scores"], got["rows"], ws, wi)
    finally:
        srv.shutdown()
        srv.server_service.close()
        srv.server_close()
        thread.join(timeout=10)
    log("phase 4 serving 1M items over HTTP: request latencies (first ones "
        "compile) " + ", ".join(f"{1e3 * t:.1f}" for t in lat)
        + f" ms ({card})")


def als_interactions(num_users: int, num_items: int, per_user: int,
                     seed: int):
    """Implicit feedback with Zipf-like item popularity, made in bulk."""
    from spotify_recommender_tpu.models.mf import Interactions

    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.8
    items = rng.choice(num_items, size=num_users * per_user, p=pop / pop.sum())
    users = np.repeat(np.arange(num_users), per_user)
    pair = np.unique(users.astype(np.int64) * num_items + items)
    users, items = np.divmod(pair, num_items)
    counts = 1.0 + rng.poisson(3.0, size=len(pair)).astype(np.float32)
    return Interactions.from_coo(users, items, counts, num_users, num_items)


def phase_training(card: str) -> None:
    from spotify_recommender_tpu.core.config import MFConfig
    from spotify_recommender_tpu.models import mf

    inter = als_interactions(100_000, 20_000, 30, seed=3)
    t0 = time.perf_counter()
    users, items = mf.train_als(
        inter, MFConfig(embedding_dim=64, num_iterations=2)
    )
    dt = time.perf_counter() - t0
    assert users.shape == (inter.num_users, 64)
    assert items.shape == (inter.num_items, 64)
    assert np.isfinite(users).all() and np.isfinite(items).all()
    log(f"phase 5 ALS 2 iterations 100000x20000 d=64: {dt:.2f} s "
        f"including compile ({card})")


def four_cards(card: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from spotify_recommender_tpu.core.config import MeshConfig
    from spotify_recommender_tpu.core.mesh import make_mesh
    from spotify_recommender_tpu.models import mf
    from spotify_recommender_tpu.retrieval.retriever import Retriever

    mesh = make_mesh(MeshConfig(data=1, catalog=4))
    n, b = 10_000_000, 1024
    cat = synthetic_catalog(n, 12, seed=n + 12)
    one = Retriever(cat)
    sharded = Retriever(cat, mesh=mesh)
    sc = sharded._sharded
    devices = {s.device for s in sc.features.addressable_shards}
    assert len(devices) == 4, f"catalog shards on {devices}"
    rows = np.random.default_rng(4).integers(0, len(cat), b)
    rows = rows.astype(np.int32)
    q, ex = jnp.asarray(cat.features[rows]), jnp.asarray(rows)
    s1, i1 = one.retrieve(q, K, ex)
    s4, i4 = sharded.retrieve(q, K, ex)
    mismatched = int((np.asarray(i1) != np.asarray(i4)).sum())
    assert mismatched == 0, f"sharded indices differ at {mismatched} slots"
    err = float(jnp.abs(s1 - s4).max())
    assert err <= SCORE_TOL, err
    t_one = timed(lambda: one.retrieve(q, K, ex))
    t_four = timed(lambda: sharded.retrieve(q, K, ex))
    log(f"four cards: catalog shards on {len(devices)} devices "
        f"({sc.n_local} rows each), path per shard "
        f"{sc.path_for(b, K)}; 10Mx12 B={b} indices equal to one card, "
        f"max |score diff| {err:.3g}; one card {t_one:.3f} ms, "
        f"four cards {t_four:.3f} ms ({card})")

    inter = als_interactions(40_000, 8_000, 30, seed=5)
    rng = np.random.default_rng(6)
    other = rng.normal(size=(8_000, 64)).astype(np.float32) / 8.0
    idx, conf, mask = inter.item_idx, inter.confidence, inter.mask
    want = mf._als_half_step(
        None, jnp.asarray(other), jnp.asarray(idx), jnp.asarray(conf),
        jnp.asarray(mask), reg=0.01, alpha=40.0,
    )
    sh = NamedSharding(mesh, P("catalog", None))
    step = mf.make_sharded_table_half_step(mesh, reg=0.01, alpha=40.0)
    got = step(*(jax.device_put(jnp.asarray(x), sh)
                 for x in (other, idx, conf, mask)))
    rel = float(jnp.abs(got - want).max() / jnp.abs(want).max())
    assert np.isfinite(np.asarray(got)).all()
    assert rel <= 1e-3, f"sharded ALS half-step differs: rel {rel:.3g}"
    log(f"four cards: sharded-table ALS half-step 40000x8000 d=64 matches "
        f"one card, max rel diff {rel:.3g} ({card})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card mesh path")
    args = parser.parse_args(argv)

    import jax

    from spotify_recommender_tpu.core.compile_cache import (
        configure_compile_cache,
    )

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    configure_compile_cache()
    card = card_line()
    log(card)
    log(f"phase 1 device: {len(devices)} x {devices[0].device_kind}")

    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(card)
    else:
        phase_cli(card)
        phase_retrieval(card)
        phase_serving(card)
        phase_training(card)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s ({card})")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
