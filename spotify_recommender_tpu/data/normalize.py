"""Feature normalization: jit-compiled min-max pipeline.

Replacement for the reference's OpenMP normalize pass
(reference DataManager.cpp:270-301).  Exact behavioral contract:

- per-feature min/max over *valid* rows only (DataManager.cpp:273-280);
- normalized = (raw - min) / range when range > 1e-4, else the constant
  0.5 (DataManager.cpp:291-295), computed in fp32;
- feature[11] = genre_id / max(1, num_genres - 1) (DataManager.cpp:299).

All math runs as one fused XLA program — a memory-bound elementwise
pass on any device; the jit also makes the pipeline
vmappable and differentiable for downstream feature towers.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spotify_recommender_tpu.core.config import (
    CONSTANT_FEATURE_VALUE,
    MINMAX_RANGE_FLOOR,
)


def feature_min_max(raw: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-column min/max of the raw feature matrix (N, F) in fp32."""
    raw = jnp.asarray(raw, dtype=jnp.float32)
    return jnp.min(raw, axis=0), jnp.max(raw, axis=0)


@partial(jax.jit, static_argnames=("range_floor", "constant_value"))
def minmax_normalize(
    raw: jnp.ndarray,
    min_vals: jnp.ndarray,
    max_vals: jnp.ndarray,
    range_floor: float = MINMAX_RANGE_FLOOR,
    constant_value: float = CONSTANT_FEATURE_VALUE,
) -> jnp.ndarray:
    """(raw - min) / range with the constant-feature rule, fp32.

    Matches reference DataManager.cpp:290-296 fp32-faithfully (within 1 ulp;
    XLA may lower division as reciprocal-multiply): the comparison is
    `range > 1e-4f` on the fp32 range, and all math stays in fp32.
    """
    raw = jnp.asarray(raw, dtype=jnp.float32)
    min_vals = jnp.asarray(min_vals, dtype=jnp.float32)
    max_vals = jnp.asarray(max_vals, dtype=jnp.float32)
    rng = max_vals - min_vals
    scaled = (raw - min_vals[None, :]) / rng[None, :]
    return jnp.where(
        rng[None, :] > jnp.float32(range_floor),
        scaled,
        jnp.float32(constant_value),
    )


@jax.jit
def encode_genre_feature(genre_ids: jnp.ndarray, num_genres: jnp.ndarray) -> jnp.ndarray:
    """Ordinal genre encoding: id / max(1, G-1) in fp32
    (reference DataManager.cpp:299)."""
    denom = jnp.maximum(jnp.int32(1), jnp.asarray(num_genres, jnp.int32) - 1)
    return genre_ids.astype(jnp.float32) / denom.astype(jnp.float32)


def build_feature_matrix(
    raw_features: np.ndarray, genre_ids: np.ndarray, num_genres: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full featurization: 11 normalized audio features + genre feature.

    Returns (features (N, 12) fp32, min_vals (11,), max_vals (11,)).
    """
    if raw_features.shape[0] == 0:
        f = np.zeros((0, raw_features.shape[1] + 1), dtype=np.float32)
        z = np.zeros((raw_features.shape[1],), dtype=np.float32)
        return f, z, z
    # Host numpy fp32 math (identical semantics to the jit kernels above):
    # preprocessing is a one-shot host pipeline, and paying a device compile
    # for an elementwise pass over a few-MB matrix is a net loss.  The jit
    # versions exist for on-device re-featurization inside larger programs.
    raw = np.ascontiguousarray(raw_features, dtype=np.float32)
    min_vals = raw.min(axis=0)
    max_vals = raw.max(axis=0)
    rng = max_vals - min_vals
    with np.errstate(divide="ignore", invalid="ignore"):
        scaled = (raw - min_vals[None, :]) / rng[None, :]
    audio = np.where(
        rng[None, :] > np.float32(MINMAX_RANGE_FLOOR),
        scaled,
        np.float32(CONSTANT_FEATURE_VALUE),
    ).astype(np.float32)
    denom = np.float32(max(1, int(num_genres) - 1))
    genre = genre_ids.astype(np.float32) / denom
    feats = np.concatenate([audio, genre[:, None]], axis=1)
    return feats.astype(np.float32), min_vals, max_vals
