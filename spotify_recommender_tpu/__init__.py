"""spotify_recommender_tpu — a candidate-retrieval and recommender framework
in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
CUDA/C++ recommender (``Iamdarika/Spotify_recommender``): CSV → normalized
catalog preprocessing, exact cosine top-k retrieval, plus the extended scope of
the north-star baseline — batched retrieval fused on-device, sharded catalogs
over device meshes, ALS/SGD matrix factorization, and two-tower training.

Layer map (see SURVEY.md §7):

- ``core``      — config dataclasses, mesh/device setup, logging, rng
- ``data``      — feature schema, CSV ingest, jit normalization, catalog artifact
- ``ops``       — jnp oracle scorer + the fused score/top-k Triton kernel
- ``retrieval`` — Catalog + Retriever API (by row / id / name, batched)
- ``models``    — ALS & SGD matrix factorization, two-tower
- ``parallel``  — mesh specs, sharded catalog, partial top-k + allgather merge
- ``train``     — train loops, checkpointing
- ``cli``       — `preprocess`, `recommend`, `train`, `serve`, `benchmark`
"""

from spotify_recommender_tpu.version import __version__

__all__ = [
    "__version__",
    "Catalog",
    "Retriever",
    "RetrievalConfig",
    "MeshConfig",
    "preprocess_csv",
]


def __getattr__(name):
    # Lazy re-exports: keep `import spotify_recommender_tpu` cheap (no JAX
    # device init) while exposing the primary API at the package root.
    if name == "Catalog":
        from spotify_recommender_tpu.data.catalog import Catalog

        return Catalog
    if name == "preprocess_csv":
        from spotify_recommender_tpu.data.catalog import preprocess_csv

        return preprocess_csv
    if name == "Retriever":
        from spotify_recommender_tpu.retrieval.retriever import Retriever

        return Retriever
    if name in ("RetrievalConfig", "MeshConfig"):
        from spotify_recommender_tpu.core import config

        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
