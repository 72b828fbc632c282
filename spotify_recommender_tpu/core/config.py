"""Typed configuration for the whole framework.

The reference exposes its knobs as hardcoded constants and argv flags
(reference main.cpp:144-180, Song.h:12, DataManager.cpp:168,292,
Recommender.cu:68,232).  Here every knob is an explicit dataclass field so the
CLI, tests, and library callers share one source of truth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# The 12-feature contract of the reference data model (reference Song.h:12-19):
# 11 numeric audio features + ordinally-encoded genre as feature[11]
# (reference DataManager.cpp:299).
FEATURE_COUNT = 12

# Numeric guards lifted from the reference math (cited per field below).
COSINE_EPS = 1e-8          # zero-norm guard   (reference Recommender.cu:68)
MINMAX_RANGE_FLOOR = 1e-4  # constant-feature floor (reference DataManager.cpp:292)
CONSTANT_FEATURE_VALUE = 0.5  # value for constant features (DataManager.cpp:295)


@dataclasses.dataclass(frozen=True)
class CatalogConfig:
    """Catalog artifact + preprocessing knobs.

    Mirrors the reference preprocessing contract
    (reference DataManager.cpp:94-361).
    """

    feature_count: int = FEATURE_COUNT
    range_floor: float = MINMAX_RANGE_FLOOR
    constant_feature_value: float = CONSTANT_FEATURE_VALUE
    # dtype of the device-resident feature matrix. fp32 preserves exact parity
    # with the reference math; bf16 halves HBM traffic for large catalogs.
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout.

    axis "data"    — data parallelism over the query batch
    axis "catalog" — tensor parallelism over catalog rows (row-sharded items)
    """

    data: int = 1
    catalog: int = 1
    axis_names: Sequence[str] = ("data", "catalog")

    @property
    def num_devices(self) -> int:
        return self.data * self.catalog


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Retrieval knobs (reference defaults: top-10, main.cpp:166).

    Retrieval is exact fp32 cosine, always: `dtype` and `exact_scores`
    accept only those values, so no caller can run an approximate tier
    under an exact label (or the reverse)."""

    top_k: int = 10
    # guard used when normalizing by the product of norms
    eps: float = COSINE_EPS
    # False forces the XLA paths even where retrieval/path.py would pick
    # the fused Triton kernel.
    use_pallas: bool = True
    dtype: str = "float32"
    # reproduce the reference's division-form cosine epilogue
    # (dot / (|x||q|) with the 1e-8 product guard)
    exact_scores: bool = True

    def __post_init__(self) -> None:
        if self.dtype != "float32":
            raise ValueError(
                f"RetrievalConfig.dtype={self.dtype!r}: only exact float32 "
                "retrieval exists"
            )
        if not self.exact_scores:
            raise ValueError(
                "RetrievalConfig.exact_scores=False: only the exact "
                "reference epilogue exists"
            )


@dataclasses.dataclass(frozen=True)
class MFConfig:
    """Matrix-factorization trainer (ALS + SGD variants)."""

    embedding_dim: int = 64
    reg: float = 0.01          # L2 regularization lambda
    alpha: float = 40.0        # implicit-feedback confidence scale (iALS)
    num_iterations: int = 10   # ALS sweeps
    learning_rate: float = 0.05  # SGD variant
    batch_size: int = 8192
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """Two-tower retrieval model with in-batch softmax negatives."""

    embedding_dim: int = 64
    hidden_dims: Sequence[int] = (256, 128)
    temperature: float = 0.05
    learning_rate: float = 1e-3
    batch_size: int = 1024
    num_steps: int = 1000
    seed: int = 0
    # "bfloat16" runs tower matmuls/activations in bf16 while params, the
    # L2-normalize epilogue, the loss, and optimizer state stay fp32
    # (standard mixed precision); "float32" = full precision
    compute_dtype: str = "float32"
    # False: the ITEM tower skips L2 normalization so embedding magnitude
    # can encode popularity (the query side stays unit-norm); cosine
    # towers structurally cannot use popularity.  Default True (unit-norm)
    # for cosine-MIPS serving.
    normalize_items: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Shared training-loop knobs (checkpointing, logging cadence)."""

    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    log_every: int = 10
