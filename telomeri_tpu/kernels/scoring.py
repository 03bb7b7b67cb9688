"""Overlap-extension scoring: SI / OS / ES (SURVEY.md §3 row 5).

Reference parity: the C++ reference computes these per-edge at graph build (HERA formulas;
mount empty, SURVEY.md §0). Two implementations share ONE op order:

  - `score_arrays_np`    : numpy float32 oracle (host pipeline + tests)
  - `score_overlaps_jnp` : jnp implementation, left to XLA (`score_os_es2_jnp` is its
    (os, es2) half, the device rescore path). The work is elementwise (8 int32 in,
    2 f32 out = 40 B/row for the rescore path, no reuse), so XLA's one loop fusion is
    bound by memory bandwidth; a hand-written Pallas-Triton kernel measured no faster
    on an H100 (PERF.md Findings, PR 1).

Formulas (ScaffoldConfig docstring has the geometry definitions):
  SI  = nmatch / blocklen
  OS  = SI * (OL1 + OL2) * 0.5
  pen = (OH1 + OH2) * 0.5
  ES1 = OS + EL1 * 0.5 - pen
  ES2 = OS + EL2 * 0.5 - pen
All arithmetic in float32, in exactly this order.

Cross-backend precision note (measured): numpy and CPU jnp are bit-identical
(tests/test_scoring.py). On an H100, XLA's code for the same formula is not: its
float32 division is not correctly rounded, so SI differs from numpy by up to 2 ulp
(SI is an exact int->f32 conversion and one division, so the division is the only
cause), OS by up to 3 ulp, and ES inherits OS's error (up to 2.0 absolute on 64M
random rows whose OS reaches 3e7; tests/test_gpu.py, chip_smoke.py). Therefore a RUN
computes scores exactly once with one backend, and every downstream decision (CSR
edge order, greedy argmax, MC sampling) uses those stored scores — results are
deterministic within a run and across hosts, while a GPU run that rescores on the
device (device_scoring="on", or "auto" at >= 32M edges) may differ from a CPU run
where a ranking decision sits within those ulps. Below the threshold the host numpy
scores stand on every backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _score_formula(xp, nm, bl, ol1, ol2, oh1, oh2, el1, el2):
    """The one true op order (xp = np or jnp), float32 in/out."""
    f = lambda a: a.astype(xp.float32)
    si = f(nm) / xp.maximum(f(bl), xp.float32(1.0))
    os_ = si * ((f(ol1) + f(ol2)) * xp.float32(0.5))
    pen = (f(oh1) + f(oh2)) * xp.float32(0.5)
    es1 = os_ + f(el1) * xp.float32(0.5) - pen
    es2 = os_ + f(el2) * xp.float32(0.5) - pen
    return si, os_, es1, es2


def score_arrays_np(nm, bl, ol1, ol2, oh1, oh2, el1, el2):
    """Numpy float32 oracle. Returns (si, os, es1, es2)."""
    return _score_formula(np, nm, bl, ol1, ol2, oh1, oh2, el1, el2)


@jax.jit
def score_overlaps_jnp(nm, bl, ol1, ol2, oh1, oh2, el1, el2):
    """jnp implementation (any backend). Returns (si, os, es1, es2)."""
    return _score_formula(jnp, nm, bl, ol1, ol2, oh1, oh2, el1, el2)


@jax.jit
def score_os_es2_jnp(nm, bl, ol1, ol2, oh1, oh2, el1, el2):
    """(os, es2) only: the two columns io/geometry.py rescore_edges_device
    consumes; XLA drops the other outputs' work and writes."""
    _, os_, _, es2 = _score_formula(jnp, nm, bl, ol1, ol2, oh1, oh2, el1, el2)
    return os_, es2


def score_overlaps(nm, bl, ol1, ol2, oh1, oh2, el1, el2, backend: str = "auto"):
    """Device scoring entry point. "auto" and "jnp" both run score_overlaps_jnp;
    any other backend name is an error."""
    if backend not in ("auto", "jnp"):
        raise ValueError(f"scoring backend must be auto/jnp, got {backend!r}")
    return score_overlaps_jnp(nm, bl, ol1, ol2, oh1, oh2, el1, el2)
