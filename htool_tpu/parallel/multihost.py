"""Multi-process execution — the MPI-multi-node analog (SURVEY.md §5).

The reference scales across nodes with plain MPI ranks; here the same role
is played by one JAX process per host (or per GPU) with a GLOBAL mesh over
all of their devices: ``jax.distributed.initialize`` wires the processes
together, and every collective in the package (psum / all_gather /
ppermute under shard_map) then runs over NCCL between GPUs with no code
changes — shard_map programs are written against the global mesh regardless
of how many processes back it.

This module provides the process-setup helpers; the operators and solvers
are already mesh-global.  In a single process (or under the CPU-emulated
mesh) everything degrades to the local device list.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize_multihost", "global_mesh", "is_multihost"]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Wire up multi-process JAX (the MPI_Init analog).

    Give the coordinator explicitly (``"host:port"``, the process count and
    this process's id), or set ``JAX_COORDINATOR_ADDRESS`` (with
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``) and call with no
    arguments.  A GPU host tells JAX nothing of a cluster by itself, so
    with neither this is single-process and a no-op, as it is when already
    initialized.

    Must run before any backend use: probing ``jax.process_count()`` (or
    touching any array) initializes the local backend and silently breaks
    ``jax.distributed.initialize`` — hence the client check below."""
    if jax.distributed.is_initialized():
        return  # already initialized
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
        if coordinator_address is None:
            return  # single-process — nothing to do
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
        process_id = int(os.environ["JAX_PROCESS_ID"])
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        # double-initialize or non-distributed environment
        pass


def is_multihost() -> bool:
    return jax.process_count() > 1


def global_mesh(axis_name: str = "p", devices=None) -> Mesh:
    """1-D mesh over ALL devices of ALL processes (``jax.devices()`` is
    global after ``initialize_multihost``) — the communicator the
    row-partitioned operator shards over.  Build the cluster tree with
    ``n_partitions = mesh.devices.size``."""
    devs = np.array(jax.devices() if devices is None else devices)
    return Mesh(devs, (axis_name,))
