"""Device / mesh setup.

Replacement for the reference's GPU device manager
(reference Recommender.cu:100-182: cudaGetDeviceCount → cudaSetDevice(0) →
dlopen cuBLAS, with a 7-point CPU fallback ladder).  In JAX the fallback is
free by construction — the same program runs on the CPU backend — so the
"device manager" reduces to constructing a `jax.sharding.Mesh` and reporting
what we found.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from spotify_recommender_tpu.core.config import MeshConfig
from spotify_recommender_tpu.core.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str
    num_devices: int
    device_kind: str


def device_info() -> DeviceInfo:
    devs = jax.devices()
    return DeviceInfo(
        platform=devs[0].platform,
        num_devices=len(devs),
        device_kind=devs[0].device_kind,
    )


def make_mesh(config: Optional[MeshConfig] = None, devices=None) -> Mesh:
    """Build a 2-D ("data", "catalog") mesh.

    With the default config the mesh spans all visible devices on the
    "catalog" axis (row-sharded catalog = the workload's natural TP axis);
    a single device yields a trivial 1x1 mesh that still lets every
    shard_map'd function run unchanged.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    if config is None:
        config = MeshConfig(data=1, catalog=len(devices))
    n = config.num_devices
    if n > len(devices):
        raise ValueError(
            f"MeshConfig wants {n} devices but only {len(devices)} are visible"
        )
    grid = np.asarray(devices[:n]).reshape(config.data, config.catalog)
    return Mesh(grid, axis_names=tuple(config.axis_names))
