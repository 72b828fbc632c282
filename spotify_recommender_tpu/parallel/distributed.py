"""Multi-host bootstrap + mesh construction.

The reference has no distributed backend at all (SURVEY.md §2: the only
data movement is cudaMemcpy within one process).  Here
`jax.distributed.initialize()` wires all hosts into one JAX runtime;
collectives compiled by XLA then ride NVLink within a host and the
network across hosts.  This module wraps the bootstrap with fail-fast diagnostics
(SURVEY.md §5 failure-detection: no elastic recovery — a missing host is a
configuration error, reported clearly and immediately).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from spotify_recommender_tpu.core.logging import get_logger

log = get_logger(__name__)

_initialized = False


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: int = 120,
) -> None:
    """Initialize the multi-host JAX runtime (idempotent).

    Pass the arguments explicitly (or via JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID); nothing detects a cluster.
    """
    global _initialized
    # IMPORTANT: probe with jax.distributed.is_initialized(), never
    # jax.process_count() — the latter initializes the XLA backend, after
    # which jax.distributed.initialize() refuses to run (found by
    # tests/test_distributed_multiprocess.py, the first time this
    # bootstrap executed with >1 real process)
    if _initialized or jax.distributed.is_initialized():
        _initialized = True
        return
    kwargs = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = (
            coordinator_address or os.environ["JAX_COORDINATOR_ADDRESS"]
        )
        kwargs["num_processes"] = int(
            num_processes or os.environ.get("JAX_NUM_PROCESSES", 1)
        )
        kwargs["process_id"] = int(
            process_id or os.environ.get("JAX_PROCESS_ID", 0)
        )
    try:
        jax.distributed.initialize(
            **kwargs,
            initialization_timeout=timeout_s,
        )
    except Exception as e:
        raise RuntimeError(
            "multi-host initialization failed — check that every host in "
            "the slice is running, the coordinator address is reachable, "
            f"and process ids are unique. Underlying error: {e}"
        ) from e
    _initialized = True
    log.info(
        "multi-host ready: process %d/%d, %d local + %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def global_mesh(
    axis_names: Sequence[str] = ("data", "catalog"),
    axis_sizes: Optional[Sequence[int]] = None,
) -> Mesh:
    """A mesh over ALL devices of all hosts.

    Default layout: all devices on "catalog" (row-sharded corpus — the
    retrieval workload's natural TP axis); pass axis_sizes to split, e.g.
    (num_hosts, devices_per_host) so the catalog axis stays intra-host
    (NVLink) and data parallelism crosses hosts — the bandwidth-correct
    orientation, since per-shard top-k candidates are tiny compared to
    gradient/batch traffic.
    """
    devices = jax.devices()
    if axis_sizes is None:
        axis_sizes = (1, len(devices))
    if int(np.prod(axis_sizes)) != len(devices):
        raise ValueError(
            f"axis_sizes {axis_sizes} does not cover {len(devices)} devices"
        )
    grid = np.asarray(devices).reshape(tuple(axis_sizes))
    return Mesh(grid, tuple(axis_names))
