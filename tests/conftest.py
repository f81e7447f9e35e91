"""Test configuration.

Tests run on the CPU with 8 virtual devices (multi-device sharding is tested
on an emulated mesh — the analog of the reference's ``mpiexec -np {1..4}``
CTest pattern, SURVEY.md §4) and with 64-bit enabled for parity with the
float64/complex128 reference.

``JAX_PLATFORMS`` picks another platform: the tests marked ``gpu`` run on
the card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` and skip
elsewhere.  Whether a card is present is decided inside the ``gpu`` fixture,
never while a module is imported, so every worker collects the same tests.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {platform!r} "
                    "(run with JAX_PLATFORMS=cuda)")
