"""What a measurement says about the device it ran on.

Every number a benchmark or smoke run prints is labelled with the JAX device
(platform, device_kind, count) and the card as nvidia-smi names it, with its power
limit: a card set below its maximum power runs slower under load. A measurement
path that finds no GPU fails; it does not fall back to the CPU.
"""

from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of JAX's devices; raises RuntimeError unless
    JAX's default backend is a GPU."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {d.platform!r} ({d.device_kind})")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def gpu_cards() -> list[str]:
    """One 'name, power.limit' line per card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
