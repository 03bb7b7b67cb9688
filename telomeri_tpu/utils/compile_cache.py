"""Persistent XLA compilation cache: one placement rule for every entry point.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no code here sets
another directory. Otherwise the cache is `<checkout>/.jax_cache`, a fixed path
computed from this package's location, so every process of one checkout (the CLI,
bench.py, chip_smoke.py, the driver hooks) shares it and a later run finds what an
earlier one compiled.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")

BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return it.
    Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR


def record_compile_seconds(metrics) -> None:
    """Accumulate XLA backend-compile wall time into metrics["compile_s"] for
    the rest of the process. A warm persistent cache skips backend compiles,
    so this is the cold-compile share of a run's stage timers."""
    import jax

    metrics.set("compile_s", 0.0)

    def on_duration(event: str, duration: float, **_kw) -> None:
        if event == BACKEND_COMPILE_EVENT:
            metrics.set("compile_s", metrics.values["compile_s"] + duration)

    jax.monitoring.register_event_duration_secs_listener(on_duration)
