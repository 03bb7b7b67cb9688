"""Slow-dispatch monitor for the pipeline's device stages.

A device stage that takes far longer than usual (a cold compile, a contended card,
a hang) should be loud in the log and visible in the run's metrics. This module
gives every device dispatch in the pipeline:

  - a PER-DISPATCH wall-clock record in the run's metrics JSON
    (metrics["dispatches"][key] = {"s": [...], "hist_s": ..., "slow": ...}),
  - a persistent cross-run history (EWMA per dispatch key, keyed by stage +
    shape bucket, in ~/.cache/telomeri-tpu/dispatch_history.json) so a run can
    compare against what the same dispatch USUALLY costs,
  - a live monitor thread that WARNS while a dispatch is still in flight past
    max(30 s, 10x its historical time) — a hang is loud, not silent — and keeps
    warning every 60 s,
  - a completion check that warns when a finished dispatch exceeded 5x history
    (telemetry, not an error: results are still correct).

The reference (single-process C++) has no analog; this is operational tooling
(SURVEY.md §6 observability).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

from telomeri_tpu.utils.logging import log

HISTORY_PATH = os.path.join(
    os.path.expanduser(os.environ.get("TELOMERI_CACHE", "~/.cache/telomeri-tpu")),
    "dispatch_history.json")
_EWMA = 0.3          # weight of the newest observation
_WARN_FACTOR = 5.0   # completed-dispatch slowness threshold vs history
_HANG_FACTOR = 10.0  # in-flight warning threshold vs history
_HANG_FLOOR_S = 30.0
_REPEAT_S = 60.0


def _load_history(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_history(path: str, hist: dict) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(hist, f)
        os.replace(tmp, path)
    except OSError:   # observability must never fail the run
        pass


class DispatchWatch:
    """Per-run dispatch timer. One instance per pipeline run; reuse across
    stages so the metrics land in one place."""

    def __init__(self, metrics=None, history_path: str | None = None):
        self.metrics = metrics
        self.path = history_path or HISTORY_PATH
        self.history = _load_history(self.path)

    @contextmanager
    def watch(self, key: str):
        """Time one device dispatch. The body should BLOCK until the results
        are materialized (block_until_ready / host fetch) — async launch time
        measures nothing."""
        hist = self.history.get(key)
        hang_after = max(_HANG_FLOOR_S,
                         _HANG_FACTOR * hist if hist else _HANG_FLOOR_S)
        t0 = time.perf_counter()
        done = threading.Event()

        def monitor():
            if not done.wait(hang_after):
                while not done.is_set():
                    dt = time.perf_counter() - t0
                    log.warning(
                        "dispatch %s still in flight after %.0fs%s — cold "
                        "compile, contended device, or hang",
                        key, dt,
                        f" ({dt / hist:.0f}x its usual {hist:.1f}s)" if hist else "")
                    done.wait(_REPEAT_S)

        th = threading.Thread(target=monitor, daemon=True)
        th.start()
        try:
            yield
        finally:
            done.set()
            dt = time.perf_counter() - t0
            slow = bool(hist and dt > _WARN_FACTOR * max(hist, 1.0))
            if slow:
                log.warning(
                    "dispatch %s took %.1fs = %.0fx its usual %.1fs (cold "
                    "compile or contended device; results are unaffected)",
                    key, dt, dt / hist, hist)
            new = dt if hist is None else (1 - _EWMA) * hist + _EWMA * dt
            self.history[key] = new
            # merge-on-save: reload and update only this key, so concurrent
            # runs sharing the cache don't clobber each other's entries
            merged = _load_history(self.path)
            merged[key] = new
            _save_history(self.path, merged)
            if self.metrics is not None:
                d = self.metrics.values.setdefault("dispatches", {})
                rec = d.setdefault(key, {"s": [], "hist_s": None, "slow": False})
                rec["s"].append(round(dt, 4))
                rec["hist_s"] = round(new, 4)
                rec["slow"] = rec["slow"] or slow
