"""Scalar single-walk oracle: the obviously-correct reference for the walk engine.

Two roles (SURVEY.md §5 item 2 and §7 "Performance baseline"):
  1. Parity testing: with `choice_fn = jax_choice_fn(seed)` wired to the SAME
     jax.random stream the engine uses, every decision (greedy and Monte-Carlo) must
     match walk/engine.py exactly.
  2. CPU baseline: with the fast default RNG, this is the "single-core CPU reference"
     that bench.py divides the device engine's walks/s by (the C++ reference was
     unreadable, so this oracle stands in; it is a faithful scalar transcription of
     the same per-step work the C++ tool performs).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

from telomeri_tpu.graph.tensorize import GraphTensors
from telomeri_tpu.walk.plan import MODE_GREEDY_OS, MODE_MC


@dataclass
class OracleWalk:
    nodes: list[int]
    eids: list[int]
    steps: int
    success: bool
    terminal: int
    path_len: int
    score_sum: float


def jax_choice_fn(seed: int, max_steps: int):
    """Per-(uid, step) sampler matching walk/engine.py's stream and integer
    inverse-CDF math exactly: same per-uid fixed-counter draw
    (engine._stable_bits_table: step s = lane s%2 of threefry2x32 on counters
    (2*(s//2), 2*(s//2)+1) — a stable prefix, invariant to max_steps) -> same
    32-bit draw -> same int32 cumsum comparison. Receives the row's PRECOMPUTED
    weight cumsum (GraphTensors.cumw), so hierarchical child slots — whose weight
    is a subtree sum, not derivable from the stored ES — sample identically."""
    import jax

    from telomeri_tpu.walk.engine import _stable_bits_table

    uid_stream = jax.jit(
        lambda u: _stable_bits_table(seed, u, max_steps)[:, 0])
    cache: dict[int, np.ndarray] = {}

    def fn(uid: int, step: int, cum_row: np.ndarray) -> int:
        stream = cache.get(uid)
        if stream is None:
            stream = cache[uid] = np.asarray(
                uid_stream(np.array([uid], np.int32)))
        total = int(cum_row[-1])
        if total <= 0:
            return -1
        r = (int(stream[step]) & 0x7FFFFFFF) % total
        return int(np.argmax(cum_row > r))

    return fn


def fast_choice_fn(seed: int):
    """Cheap python RNG for baseline benchmarking (decisions need not match the
    engine). Does the same O(K) per-step sampling work over the row cumsum."""
    rngs: dict[int, random.Random] = {}

    def fn(uid: int, step: int, cum_row: np.ndarray) -> int:
        r = rngs.get(uid)
        if r is None:
            r = rngs[uid] = random.Random((seed << 32) ^ uid)
        total = int(cum_row[-1])
        if total <= 0:
            return -1  # dead end (no positive-weight candidate) — like the engine
        x = r.random() * total
        for j, v in enumerate(cum_row):
            if v > x:
                return j
        return len(cum_row) - 1

    return fn


def walk_oracle(
    g: GraphTensors,
    start: int,
    first_edge: int,
    mode: int,
    uid: int,
    max_steps: int,
    choice_fn,
) -> OracleWalk:
    """One walk, scalar semantics identical to run_walks (see engine docstring).

    The oracle traverses the TENSORIZED rows (including hierarchical virtual
    nodes), so hub semantics match the engine bit-for-bit by construction."""
    anchor_lim = 2 * g.n_anchors
    nbr, es, osb, adv, eid = g.nbr, g.es, g.os_, g.adv, g.eid
    if g.cumw is not None:
        cumw = g.cumw
    else:
        from telomeri_tpu.walk.engine import mc_weights

        cumw = np.cumsum(mc_weights(es), axis=1, dtype=np.int64)
    cur = start
    path = [start]
    eids: list[int] = []
    plen = 0
    score = np.float32(0.0)
    for s in range(max_steps):
        row_n = nbr[cur]
        row_os = osb[cur]
        k = len(row_n)
        valid = [row_n[j] >= 0 and int(row_n[j]) not in path for j in range(k)]

        if s == 0 and first_edge >= 0:
            choice = first_edge
            if not valid[choice]:
                break
        elif mode == MODE_MC:
            # sample the FULL static row distribution; revisits kill below
            choice = choice_fn(uid, s, np.asarray(cumw[cur]))
            if choice < 0:
                break
        elif mode == MODE_GREEDY_OS:
            best, choice = -np.inf, -1
            for j in range(k):
                if valid[j] and row_os[j] > best:
                    best, choice = float(row_os[j]), j
            if choice < 0:
                break
        else:
            # greedy-ES = FIRST valid slot: rows are ES-desc sorted at build time
            # (hierarchical child slots store es=0 but sit at the sorted tail, so
            # an argmax over STORED es would diverge from the engine — the engine
            # takes the first valid slot, and so must the oracle)
            choice = -1
            for j in range(k):
                if valid[j]:
                    choice = j
                    break
            if choice < 0:
                break

        nxt = int(nbr[cur][choice])
        if nxt < 0:
            break  # chosen slot is padding (defensive: no choice_fn should do this)
        if mode == MODE_MC and nxt in path:
            break  # MC cycle kill: sampled an already-visited destination
        plen += int(adv[cur][choice])
        score = np.float32(score + es[cur][choice])
        path.append(nxt)
        eids.append(int(eid[cur][choice]))
        if nxt < anchor_lim:
            return OracleWalk(path, eids, len(eids), True, nxt, plen, float(score))
        cur = nxt
    return OracleWalk(path, eids, len(eids), False, -1, plen, float(score))
