"""What the process runs on: the JAX device and the card's power limit."""

from __future__ import annotations

import subprocess


def device_info() -> dict:
    """The first JAX device as JAX reports it, and the device count."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (one line per card), read
    in a child process that stays off JAX.  Raises if nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
