"""Profiling hooks — the chrono/MPI_Wtime timing layer plus device traces.

The reference records wall-clock phase timings in info maps
(``tree_builder.hpp:308-316``, ``ddm.hpp:66-122``); this package does the
same (``HMatrix.info``, ``BLRMatrix.info``, solver ``infos``) and adds what
the reference cannot have: an xprof/perfetto DEVICE trace hook via
``jax.profiler`` for kernel-level analysis on the device.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["device_trace", "Timer", "annotate"]


@contextlib.contextmanager
def device_trace(log_dir: str, host_profile: bool = False):
    """Capture a device trace (xprof format) for the enclosed block::

        with device_trace("/tmp/htool_trace"):
            y = matvec(H, x)
            y.block_until_ready()

    View with xprof/TensorBoard or convert to perfetto.  This wraps
    ``jax.profiler.trace`` so all device kernels and
    collectives inside the block are recorded."""
    with jax.profiler.trace(log_dir, create_perfetto_trace=host_profile):
        yield


def annotate(name: str):
    """Named region for device traces (``jax.profiler.TraceAnnotation``)."""
    return jax.profiler.TraceAnnotation(name)


class Timer:
    """Accumulating wall-clock phase timer writing into an info dict —
    the ``std::chrono``/``MPI_Wtime`` pattern of the reference::

        t = Timer(infos)
        with t.phase("assembly"):
            ...
    """

    def __init__(self, infos: dict):
        self.infos = infos

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            key = f"{name}_walltime"
            self.infos[key] = self.infos.get(key, 0.0) + time.perf_counter() - t0
