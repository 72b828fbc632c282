"""Command-line interface.

Superset of the reference CLI (reference main.cpp:13-31 usage, :144-186
dispatch).  Two calling styles:

- reference-parity flags, drop-in compatible:
    ``... --preprocess dataset.csv``
    ``... --song "Bohemian Rhapsody" -n 5``
    ``... --id "3ade68b8e" -n 10``
- subcommands for the extended framework:
    ``preprocess | recommend | train-mf | train-two-tower | serve | benchmark``

The default catalog artifact is ``songs_catalog.npz`` (analog of the
reference's pinned ``songs_data.bin``, main.cpp:11) but is configurable.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from spotify_recommender_tpu.core.logging import get_logger

log = get_logger(__name__)

DEFAULT_CATALOG = "songs_catalog.npz"

BANNER = """\
+------------------------------------------------+
|      Music Retrieval & Recommendation          |
|        JAX / XLA / Pallas / pjit engine        |
+------------------------------------------------+
"""


def _load_catalog(path: str):
    from spotify_recommender_tpu.data.catalog import Catalog

    if path.endswith(".bin"):
        return Catalog.load_reference_binary(path)
    return Catalog.load(path)


def _parse_mesh(spec: Optional[str]):
    """``--mesh data=N,catalog=M`` → jax.sharding.Mesh (None when absent).

    Either axis may be omitted (defaults to 1); the product must not
    exceed the visible device count (core.mesh.make_mesh validates).
    """
    if not spec:
        return None
    from spotify_recommender_tpu.core.config import MeshConfig
    from spotify_recommender_tpu.core.mesh import make_mesh

    axes = {"data": 1, "catalog": 1}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(
                f"--mesh expects axis=N pairs (e.g. data=8,catalog=1), got {part!r}"
            )
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in axes:
            raise SystemExit(
                f"--mesh axis must be 'data' or 'catalog', got {name!r}"
            )
        axes[name] = int(val)
    return make_mesh(MeshConfig(data=axes["data"], catalog=axes["catalog"]))


def cmd_preprocess(
    csv_path: str,
    output: str,
    fmt: str = "npz",
    streaming: bool = False,
    chunk_rows: int = 200_000,
) -> int:
    from spotify_recommender_tpu.data.catalog import preprocess_csv

    print("=== PREPROCESSING MODE ===")
    if streaming or fmt == "dir":
        from spotify_recommender_tpu.data.streaming import (
            preprocess_csv_streaming,
        )

        out_dir = output[:-4] if output.endswith(".npz") else output
        cat = preprocess_csv_streaming(
            csv_path, out_dir, chunk_rows=chunk_rows
        )
        output = out_dir
    elif fmt == "bin":
        cat = preprocess_csv(csv_path, None)
        cat.save_reference_binary(output)
    elif fmt == "sharded":
        # OCDBT sharded artifact: the multi-host catalog format (restores
        # straight onto a jax Mesh; see data/sharded_catalog.py)
        from spotify_recommender_tpu.data.sharded_catalog import (
            save_sharded_catalog,
        )

        out_dir = output[:-4] if output.endswith(".npz") else output
        cat = preprocess_csv(csv_path, None)
        save_sharded_catalog(cat, out_dir)
        output = out_dir
    else:
        cat = preprocess_csv(csv_path, output)
    print(f"Valid songs: {len(cat)}")
    print(f"Unique genres: {cat.num_genres}")
    print("\nGenre Mapping:")
    for gid, name in enumerate(cat.genre_names):
        print(f"  ID {gid}: {name}")
    print(f"\nPreprocessing successful! Catalog saved to: {output}")
    return 0


def cmd_recommend(
    query: str, by_id: bool, top_n: int, catalog_path: str
) -> int:
    from spotify_recommender_tpu.retrieval.retriever import Retriever

    print("=== RECOMMENDATION MODE ===")
    cat = _load_catalog(catalog_path)
    retriever = Retriever(cat)

    kind = "track ID" if by_id else "song"
    print(f"\nSearching for {kind}: {query}")
    try:
        if by_id:
            row = retriever.index.find_by_track_id(query)
            recs = retriever.recommend_by_id(query, top_n)
        else:
            row = retriever.index.find_by_name(query)
            recs = retriever.recommend_by_name(query, top_n)
    except (KeyError, IndexError) as e:
        # str(KeyError) wraps the message in repr quotes; unwrap it
        msg = e.args[0] if e.args else str(e)
        print(f"Error: {msg}", file=sys.stderr)
        return 1

    if row is not None:
        q = retriever.lookup(row)
        # byte-parity with the reference's query-song card, including the
        # U+2501 rules (reference main.cpp:105-112)
        print("\n" + "━" * 46)
        print("Query Song:")
        print(f"  Title:   {q.track_name}")
        print(f"  Artist:  {q.artists}")
        print(f"  Genre:   {q.genre}")
        print(f"  ID:      {q.track_id}")
        print("━" * 46)

    print(f"\nTop {len(recs)} Recommendations:\n")
    for i, r in enumerate(recs):
        print(f'{i + 1}. "{r.track_name}"')
        print(f"   Artist: {r.artists}")
        print(f"   Genre:  {r.genre}")
        print(f"   ID:     {r.track_id}")
        print(f"   Score:  {r.score:.6f}")
        if i < len(recs) - 1:
            print()
    print("\n✓ Recommendation complete!")  # reference main.cpp:129
    return 0


def _retrieve_from_sharded_artifact(args, queries) -> int:
    """retrieve --catalog <ocdbt-dir> [--mesh catalog=N]: restore the
    sharded artifact onto the mesh and serve its shards where they landed
    (no host gather)."""
    import json

    import numpy as np

    from spotify_recommender_tpu.data.sharded_catalog import (
        load_sharded_catalog,
    )
    from spotify_recommender_tpu.parallel.sharding import ShardedCatalog

    mesh = _parse_mesh(args.mesh)
    if mesh is None:
        import jax

        from spotify_recommender_tpu.core.config import MeshConfig
        from spotify_recommender_tpu.core.mesh import make_mesh

        mesh = make_mesh(MeshConfig(data=1, catalog=len(jax.devices())))

    art = load_sharded_catalog(args.catalog, mesh)
    sc = ShardedCatalog.from_artifact(art, mesh)
    scores, rows = sc.retrieve(np.asarray(queries, np.float32), args.k)
    scores, rows = np.asarray(scores), np.asarray(rows)
    track_ids = art.host_column("track_ids")
    if args.output:
        np.savez_compressed(
            args.output,
            scores=scores,
            rows=rows,
            track_ids=track_ids[rows].astype(np.str_),
        )
        print(
            f"retrieved top-{args.k} for {len(queries)} queries "
            f"-> {args.output}"
        )
    else:
        for b in range(len(queries)):
            print(
                json.dumps(
                    {
                        "query": b,
                        "rows": rows[b].tolist(),
                        "scores": [round(float(s), 6) for s in scores[b]],
                        "track_ids": [str(t) for t in track_ids[rows[b]]],
                    }
                )
            )
    return 0


def cmd_retrieve(args) -> int:
    import json

    import numpy as np

    from spotify_recommender_tpu.retrieval.retriever import Retriever

    if args.queries.endswith(".npy"):
        queries = np.load(args.queries)
    else:
        with np.load(args.queries) as z:
            queries = z["queries"]
    if os.path.isdir(args.catalog) and os.path.exists(
        os.path.join(args.catalog, "meta.json")
    ):
        # OCDBT sharded artifact -> mesh restore -> sharded retrieval,
        # end to end without a full host materialization
        return _retrieve_from_sharded_artifact(args, queries)
    cat = _load_catalog(args.catalog)
    if args.streaming:
        from spotify_recommender_tpu.retrieval.streaming_retriever import (
            StreamingRetriever,
        )

        retriever = StreamingRetriever(cat.features, cat.norms)
    else:
        retriever = Retriever(cat, mesh=_parse_mesh(args.mesh))
    scores, rows = retriever.retrieve(queries, k=args.k)
    scores, rows = np.asarray(scores), np.asarray(rows)
    if args.output:
        np.savez_compressed(
            args.output,
            scores=scores,
            rows=rows,
            track_ids=cat.track_ids[rows].astype(np.str_),
        )
        print(f"retrieved top-{args.k} for {len(queries)} queries -> {args.output}")
    else:
        for b in range(len(queries)):
            print(
                json.dumps(
                    {
                        "query": b,
                        "rows": rows[b].tolist(),
                        "scores": [round(float(s), 6) for s in scores[b]],
                        "track_ids": [str(t) for t in cat.track_ids[rows[b]]],
                    }
                )
            )
    return 0


def cmd_benchmark(args) -> int:
    from spotify_recommender_tpu import benchmark

    result = benchmark.run_benchmark(
        num_items=args.items,
        num_queries=args.queries,
        feature_dim=args.dim,
        k=args.k,
        backend=args.backend,
    )
    print(benchmark.to_json_line(result))
    return 0


def cmd_train_mf(args) -> int:
    from spotify_recommender_tpu.models import mf
    from spotify_recommender_tpu.core.config import MFConfig

    cfg = MFConfig(
        embedding_dim=args.dim,
        num_iterations=args.iterations,
        reg=args.reg,
        alpha=args.alpha,
        seed=args.seed,
    )
    return mf.train_from_cli(
        args.interactions, cfg, args.output, solver=args.solver,
        mesh=_parse_mesh(args.mesh),
        shard_tables=args.shard_tables,
        checkpoint_dir=args.checkpoint_dir,
        subspace=args.subspace,
    )


def cmd_train_two_tower(args) -> int:
    from spotify_recommender_tpu.models import two_tower
    from spotify_recommender_tpu.core.config import TwoTowerConfig

    cfg = TwoTowerConfig(
        embedding_dim=args.dim,
        num_steps=args.steps,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        seed=args.seed,
    )
    return two_tower.train_from_cli(
        args.catalog, cfg, args.output,
        mesh=_parse_mesh(args.mesh),
        checkpoint_dir=args.checkpoint_dir,
        interactions_path=args.interactions,
    )


def cmd_evaluate_mf(args) -> int:
    from spotify_recommender_tpu.models import mf

    inter = mf.load_interactions(args.interactions)
    users, items = mf.load_model(args.mf)
    if users.shape[0] < inter.num_users or items.shape[0] < inter.num_items:
        print(
            f"Error: model covers {users.shape[0]} users x {items.shape[0]} "
            f"items but interactions reference {inter.num_users} x "
            f"{inter.num_items}",
            file=sys.stderr,
        )
        return 1
    _, heldout, seen = mf.split_leave_k_out(inter, k=args.holdout, seed=args.seed)
    m = mf.evaluate_ranking(users, items, heldout, k=args.k, train_mask=seen)
    print(
        f"recall@{args.k}={m['recall@k']:.4f} ndcg@{args.k}={m['ndcg@k']:.4f} "
        f"({m['num_eval_users']} users)"
    )
    return 0


def cmd_recommend_user(args) -> int:
    import numpy as np

    from spotify_recommender_tpu.models import mf

    users, items = mf.load_model(args.mf)
    exclude = (
        np.asarray([int(x) for x in args.exclude.split(",")], np.int64)
        if args.exclude
        else None
    )
    try:
        scores, item_ids = mf.recommend_for_user(
            users, items, args.user, k=args.n, exclude_items=exclude
        )
    except IndexError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    names = None
    if args.catalog:
        cat = _load_catalog(args.catalog)
        if len(cat) == items.shape[0]:
            names = cat
    print(f"Top {len(item_ids)} items for user {args.user}:\n")
    for rank, (s, i) in enumerate(zip(scores, item_ids), 1):
        if names is not None:
            print(
                f'{rank}. item {i}: "{names.track_names[i]}" '
                f"({names.artists[i]})  score={s:.4f}"
            )
        else:
            print(f"{rank}. item {i}  score={s:.4f}")
    return 0


def cmd_embed_catalog(args) -> int:
    import dataclasses as _dc

    import numpy as np

    from spotify_recommender_tpu.data.catalog import Catalog

    cat = _load_catalog(args.catalog)
    if args.two_tower:
        from spotify_recommender_tpu.models import two_tower

        params, cfg = two_tower.load_model(args.two_tower)
        emb = two_tower.embed_catalog(params, cat.features, cfg)
        source = f"two-tower {args.two_tower}"
    else:
        from spotify_recommender_tpu.models import mf

        _, items = mf.load_model(args.mf)
        if items.shape[0] != len(cat):
            print(
                f"Error: MF model has {items.shape[0]} items but catalog has "
                f"{len(cat)} — they must be row-aligned",
                file=sys.stderr,
            )
            return 1
        emb = items.astype(np.float32)
        source = f"MF {args.mf}"
    out = _dc.replace(
        cat,
        features=emb,
        norms=np.linalg.norm(emb, axis=1).astype(np.float32),
        min_vals=np.zeros(emb.shape[1] - 1, np.float32),
        max_vals=np.ones(emb.shape[1] - 1, np.float32),
    )
    out.save(args.output)
    print(f"embedded catalog ({source}): {len(out)} items x {emb.shape[1]} dims")
    print(f"saved to: {args.output}")
    return 0


def cmd_evaluate_two_tower(args) -> int:
    from spotify_recommender_tpu.models import mf, two_tower

    cat = _load_catalog(args.catalog)
    params, cfg = two_tower.load_model(args.two_tower)
    inter = mf.load_interactions(args.interactions)
    if inter.num_items > len(cat):
        print(
            f"Error: interactions reference item {inter.num_items - 1} but "
            f"the catalog has only {len(cat)} rows",
            file=sys.stderr,
        )
        return 1
    m = two_tower.evaluate_colisten(
        params, cfg, cat.features, inter,
        k=args.k, holdout=args.holdout, seed=args.seed,
    )
    print(
        f"recall@{args.k}={m['recall@k']:.4f} ndcg@{args.k}={m['ndcg@k']:.4f} "
        f"({m['num_eval_users']} users)"
    )
    return 0


def cmd_serve(args) -> int:
    from spotify_recommender_tpu.serve.server import serve

    return serve(args.catalog, host=args.host, port=args.port)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spotify_recommender_tpu", description=__doc__
    )
    sub = p.add_subparsers(dest="command")

    sp = sub.add_parser("preprocess", help="CSV -> normalized catalog artifact")
    sp.add_argument("csv")
    sp.add_argument("-o", "--output", default=DEFAULT_CATALOG)
    sp.add_argument(
        "--format", dest="fmt", default="npz",
        choices=["npz", "dir", "bin", "sharded"],
        help="npz (compressed, default) | dir (memory-mapped directory, "
             "O(0) load for multi-GB catalogs) | bin (legacy reference "
             "songs_data.bin)",
    )
    sp.add_argument(
        "--streaming", action="store_true",
        help="bounded-RAM chunked ingest (implies --format dir)",
    )
    sp.add_argument("--chunk-rows", type=int, default=200_000)

    sr = sub.add_parser("recommend", help="top-N similar songs")
    g = sr.add_mutually_exclusive_group(required=True)
    g.add_argument("--song", help="query by (case-insensitive) name")
    g.add_argument("--id", dest="track_id", help="query by exact track id")
    sr.add_argument("-n", type=int, default=10)
    sr.add_argument("--catalog", default=DEFAULT_CATALOG)

    sv = sub.add_parser(
        "retrieve", help="batched retrieval: query vectors file -> top-k"
    )
    sv.add_argument(
        "queries", help=".npz with a 'queries' (B, F) array, or .npy"
    )
    sv.add_argument("-k", type=int, default=10)
    sv.add_argument("--catalog", default=DEFAULT_CATALOG)
    sv.add_argument("-o", "--output", default=None,
                    help="write results to .npz (default: print JSON)")
    sv.add_argument("--mesh", default=None,
                    help="device mesh, e.g. data=1,catalog=8 (row-sharded catalog)")
    sv.add_argument("--streaming", action="store_true",
                    help="host-stream the catalog through the device in "
                         "windows (capacity tier for catalogs beyond "
                         "device memory; pair with a memmap catalog dir)")

    sb = sub.add_parser("benchmark", help="retrieval throughput benchmark")
    sb.add_argument("--items", type=int, default=1_000_000)
    sb.add_argument("--queries", type=int, default=1024)
    sb.add_argument("--dim", type=int, default=12)
    sb.add_argument("--k", type=int, default=10)
    sb.add_argument(
        "--backend", default="auto", choices=["auto", "xla"],
        help="auto: the path retrieval/path.py picks; xla: XLA only",
    )

    sm = sub.add_parser("train-mf", help="ALS/SGD matrix factorization")
    sm.add_argument("interactions", help="CSV/npz of (user, item, count)")
    sm.add_argument("-o", "--output", default="mf_model.npz")
    sm.add_argument("--dim", type=int, default=64)
    sm.add_argument("--iterations", type=int, default=10)
    sm.add_argument("--reg", type=float, default=0.01)
    sm.add_argument("--alpha", type=float, default=40.0)
    sm.add_argument("--solver", default="als", choices=["als", "sgd"])
    sm.add_argument("--seed", type=int, default=0)
    sm.add_argument("--mesh", default=None,
                    help="device mesh, e.g. data=8 (SGD) or catalog=8 (ALS)")
    sm.add_argument("--shard-tables", action="store_true",
                    help="row-shard the factor tables over the mesh "
                         "(for tables beyond one chip's HBM)")
    sm.add_argument("--checkpoint-dir", default=None,
                    help="Orbax checkpoint dir (resume from latest)")
    sm.add_argument("--subspace", type=int, default=0,
                    help="iALS++ block size (0 = full ALS solve; e.g. 16 "
                         "at --dim 64 for ~4x cheaper sweeps)")

    st = sub.add_parser("train-two-tower", help="two-tower retrieval model")
    st.add_argument("--catalog", default=DEFAULT_CATALOG)
    st.add_argument("-o", "--output", default="two_tower_model")
    st.add_argument("--dim", type=int, default=64)
    st.add_argument("--steps", type=int, default=1000)
    st.add_argument("--batch-size", type=int, default=1024)
    st.add_argument("--lr", type=float, default=1e-3)
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--mesh", default=None,
                    help="device mesh, e.g. data=8 (data-parallel batches)")
    st.add_argument("--checkpoint-dir", default=None,
                    help="Orbax checkpoint dir (resume from latest)")
    st.add_argument("--interactions", default=None,
                    help="user_id,item_id,count CSV/npz: train on co-listen "
                         "pairs instead of same-genre self-supervision")

    sev = sub.add_parser(
        "evaluate-mf", help="recall@k / NDCG@k of an MF model on held-out data"
    )
    sev.add_argument("interactions", help="CSV/npz of (user, item, count)")
    sev.add_argument("--mf", required=True, help="MF model .npz")
    sev.add_argument("-k", type=int, default=10)
    sev.add_argument("--holdout", type=int, default=2,
                     help="interactions held out per user")
    sev.add_argument("--seed", type=int, default=0)

    su = sub.add_parser(
        "recommend-user", help="top-N items for a user from a trained MF model"
    )
    su.add_argument("--mf", required=True, help="MF model .npz")
    su.add_argument("--user", type=int, required=True)
    su.add_argument("-n", type=int, default=10)
    su.add_argument(
        "--catalog", default=None,
        help="optional catalog for item names (rows must align with MF items)",
    )
    su.add_argument(
        "--exclude", default=None,
        help="comma-separated item ids to exclude (e.g. already-consumed)",
    )

    se = sub.add_parser(
        "embed-catalog",
        help="re-embed a catalog with a trained model; output plugs into "
        "recommend/serve unchanged (learned and hand-crafted embeddings "
        "share one serving path)",
    )
    se.add_argument("--catalog", default=DEFAULT_CATALOG)
    g2 = se.add_mutually_exclusive_group(required=True)
    g2.add_argument("--two-tower", help="two-tower model .pkl")
    g2.add_argument("--mf", help="MF model .npz (item factors)")
    se.add_argument("-o", "--output", default="embedded_catalog.npz")

    sv2 = sub.add_parser(
        "evaluate-two-tower",
        help="recall@k / NDCG@k of a two-tower model on held-out "
             "co-listen pairs",
    )
    sv2.add_argument("interactions", help="CSV/npz of (user_id,item_id,count)")
    sv2.add_argument("--two-tower", required=True, help="two-tower model file")
    sv2.add_argument("--catalog", default=DEFAULT_CATALOG)
    sv2.add_argument("-k", type=int, default=10)
    sv2.add_argument("--holdout", type=int, default=1)
    sv2.add_argument("--seed", type=int, default=0)

    ss = sub.add_parser("serve", help="HTTP retrieval service")
    ss.add_argument("--catalog", default=DEFAULT_CATALOG)
    ss.add_argument("--host", default="127.0.0.1")
    ss.add_argument("--port", type=int, default=8000)

    return p


def _parse_reference_style(argv: List[str]) -> Optional[int]:
    """Handle the reference's exact flag grammar (main.cpp:144-180)."""
    if not argv:
        return None
    mode = argv[0]
    if mode == "--preprocess":
        if len(argv) < 2:
            print("Error: CSV path required for preprocessing mode", file=sys.stderr)
            return 1
        return cmd_preprocess(argv[1], DEFAULT_CATALOG)
    if mode in ("--song", "--id"):
        if len(argv) < 2:
            print("Error: Song name or track ID required", file=sys.stderr)
            return 1
        query = argv[1]
        top_n = 10  # reference default (main.cpp:166)
        catalog = DEFAULT_CATALOG
        i = 2
        while i < len(argv) - 1:
            if argv[i] == "-n":
                try:
                    top_n = int(argv[i + 1])
                except ValueError:
                    top_n = 0
                if top_n <= 0:
                    print(
                        "Error: Invalid value for -n (must be positive)",
                        file=sys.stderr,
                    )
                    return 1
                i += 2
            elif argv[i] == "--catalog":
                catalog = argv[i + 1]
                i += 2
            else:
                i += 1
        return cmd_recommend(query, mode == "--id", top_n, catalog)
    return None


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # Global --platform override (e.g. `--platform cpu` for small host-side
    # jobs); applied before any JAX device use.
    if "--platform" in argv:
        i = argv.index("--platform")
        platform = argv[i + 1]
        argv = argv[:i] + argv[i + 2 :]
        import jax

        jax.config.update("jax_platforms", platform)
    from spotify_recommender_tpu.core.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    print(BANNER)
    ref = _parse_reference_style(argv)
    if ref is not None:
        return ref

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    if args.command == "preprocess":
        return cmd_preprocess(
            args.csv, args.output, fmt=args.fmt,
            streaming=args.streaming, chunk_rows=args.chunk_rows,
        )
    if args.command == "recommend":
        query = args.track_id if args.track_id else args.song
        return cmd_recommend(query, args.track_id is not None, args.n, args.catalog)
    if args.command == "retrieve":
        return cmd_retrieve(args)
    if args.command == "benchmark":
        return cmd_benchmark(args)
    if args.command == "train-mf":
        return cmd_train_mf(args)
    if args.command == "train-two-tower":
        return cmd_train_two_tower(args)
    if args.command == "evaluate-mf":
        return cmd_evaluate_mf(args)
    if args.command == "evaluate-two-tower":
        return cmd_evaluate_two_tower(args)
    if args.command == "recommend-user":
        return cmd_recommend_user(args)
    if args.command == "embed-catalog":
        return cmd_embed_catalog(args)
    if args.command == "serve":
        return cmd_serve(args)
    parser.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
