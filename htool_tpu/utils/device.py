"""Device description for the scripts that measure or check the card.

Every result ``bench.py`` and ``chip_smoke.py`` print names the device it
ran on: JAX's platform, device kind and device count, and the card's name
and power limit as ``nvidia-smi`` reports them (a card set below its power
limit runs slower under load).
"""

from __future__ import annotations

import subprocess

__all__ = ["device_summary", "gpu_name_and_power"]


def device_summary(devices) -> dict:
    """``{"platform", "kind", "count"}`` of a JAX device list."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def gpu_name_and_power() -> str:
    """``name, power.limit`` per card, from ``nvidia-smi`` (which stays off
    JAX); a short note where the tool is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"
