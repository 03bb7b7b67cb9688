"""Vectorized walk engine: batched greedy + Monte-Carlo path walks (the device hot loop).

Reference parity: the C++ reference's per-anchor sequential walk loop (PathManager,
SURVEY.md §3 rows 7-10; §4.1 "HOT LOOP"; mount empty, SURVEY.md §0). Accelerator
design (SURVEY.md §1 north star): thousands of walks advance in lockstep through a
`lax.scan` of cfg.max_steps fixed steps; each step is a dense (W, K) gather from the
padded CSR plus elementwise masking/argmax/sampling. No data-dependent control flow.
Plain JAX throughout; XLA compiles it for the GPU or the CPU.

Performance structure (the shape choices below were tuned on the previous
accelerator; whether each suits the GPU is open — ROADMAP.md §1 item 5):
  - Each scan step issues ONE contiguous (W, 6H) row gather from the wide per-node
    table (GraphDev.wide: [nbr | cum | eid | adv | es | 0] blocks): the transition,
    the MC draw (in-register compare-count over the cum block: first slot with
    cum > r), and the chosen slot's edge attributes all resolve from that single
    fetch with one-hot lane reduces. On the previous accelerator the
    scattered-gather OP COUNT, not bytes, dominated, so one wide fetch beat a
    narrow fetch plus a separate recon gather, and beat per-element chased
    gathers.
  - Row widths are padded to powers of two from 64 (lane_width), which on the
    previous accelerator kept the row gather on its fast path. nbr/eid pad = -1,
    adv/es pad = 0, cum pad = row total so pads are never sampled.
  - ALL RNG is hoisted out of the scan: the (S, W) table of per-step uniform bits is
    generated in one batched COUNTER draw per walk key before the scan
    (_stable_bits_table), so the scan's serial critical path carries no threefry
    hashing, and the table costs ONE threefry block per two draws instead of two
    blocks per draw (fold_in per step was much slower).
  - The MC batch section runs a HISTORYLESS scan (carry = cur only) because MC
    draws never consult the path; the kill/success events are resolved post-scan
    with vectorized masking and a pack-sort duplicate scan (see _run_walks_mc_fast;
    dropping the in-scan visited table was faster). Greedy walks genuinely
    reroute around their history, so the mixed/greedy engine keeps the in-scan
    visited table ((W, S+1) carry + revisit compare per step).
  - The scan body touches ONLY what its decisions need: greedy-OS additionally
    gathers OS rows; greedy-ES needs NO score gather at all (CSR rows are
    pre-sorted by (ES desc, dst asc), so greedy-ES = first valid slot).

Semantics (deterministic, documented — SURVEY.md §7 "bit-identical" hard part):
  - A walk starts at an oriented anchor node and repeatedly selects an out-edge.
  - mode 0 / 1 (greedy by OS / ES): candidates are non-pad slots whose destination is
    not already on this walk's path (greedy REROUTES around its history); pick the
    max-score candidate; ties resolve to the lowest CSR slot, and CSR rows are
    pre-sorted by (ES desc, dst asc), which fixes the tie-break globally.
  - mode 2 (Monte-Carlo): pick slot j with probability w_j / sum(w) over the FULL row,
    where w = mc_weights(ES) (integer ceil(ES) weights, 0 for ES <= 0 and pads),
    sampled by integer inverse-CDF against the PRECOMPUTED row cumsum (one contiguous
    row gather + compare-count: choice = #{j : cum_j <= r}). A
    draw landing on an already-visited destination KILLS the walk (HERA cycle kill,
    SURVEY.md §3 row 10); a walk with no positive-weight candidate dies. The draw
    uses the walk's OWN stream (_stable_bits_table): step s reads lane s%2 of
    threefry2x32(fold_in(key(seed), uid), counters (2*(s//2), 2*(s//2)+1)) —
    invariant to batch size, padding, sharding, host count (SURVEY.md §5 item 3),
    AND max_steps (each block hashes fixed counters, so the stream is a stable
    prefix: raising max_steps appends draws without changing earlier ones), and
    bit-reproducible across backends (integer arithmetic has no rounding).
  - Step 0 honours plan.first_edge (deterministic first-edge enumeration); an invalid
    forced slot kills the walk.
  - A walk succeeds when it steps onto another anchor node (id < 2 * n_anchors); it
    dies on candidate exhaustion; it is truncated (failure) at max_steps.

score_sum is a float32 sum over the steps taken, accumulated in step order
(_sum_steps_f32) exactly as walk/oracle.py does, so it is bit-identical on every
backend. path_len is an int32 sum — exact everywhere.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.graph.tensorize import GraphTensors
from telomeri_tpu.walk.plan import MODE_GREEDY_OS, MODE_MC, WalkPlan


class GraphDev(NamedTuple):
    """Device-resident CSR tables (see graph/tensorize.py for the host layout).

    ONE wide per-node row holds everything a walk step needs, with the CSR width
    padded from K to H = lane_width(K). wide: (N, 6H) int32, column blocks
      [0H:1H) nbr      neighbour ids (pad -1)
      [1H:2H) cum      static MC weight cumsum (pad = row total: never sampled)
      [2H:3H) eid      edge ids (pad -1)
      [3H:4H) adv      advance / path-length contribution in bp (pad 0)
      [4H:5H) es_bits  ES score f32 bits (pad 0)
      [5H:6H) os_bits  OS score f32 bits (pad 0; only greedy-OS walks read it)
    The scan issues ONE contiguous row gather per step and resolves the transition,
    the sampler, AND the per-step edge attributes from it with in-register lane
    reduces — no separate score/attr gathers anywhere. OS lives in the row's last
    block — a separate (N, H) f32 OS table cost a second scattered gather in the
    greedy path and, row-sharded, a second all_gather + psum_scatter per step
    (advisor r2)."""

    wide: jax.Array      # (N, 6H) int32

    @property
    def h(self) -> int:
        return self.wide.shape[1] // 6


def _stable_bits_table(seed, uid: jax.Array, max_steps: int) -> jax.Array:
    """(S, W) uint32 per-step MC draw table; stream prefix INVARIANT to max_steps.

    jax.random.bits(key, (S,)) pairs threefry counter lanes by the array LENGTH
    (lane i mixes with lane i + S//2), so every draw would change when max_steps
    does — a cross-config reproducibility footgun (a walk that ends in 9 steps
    should not re-decide because the step BUDGET moved from 32 to 64). Instead,
    block b is hashed from the FIXED counter pair (2b, 2b+1) regardless of how
    many blocks are drawn: step s = lane s%2 of block s//2. Same threefry cost
    as the length-paired draw (one 2x32 block per two draws); verified stable
    and engine-visible in tests/test_walk.py::test_mc_stream_stable_across_max_steps.
    """
    from jax.extend.random import threefry_2x32

    n_blocks = (max_steps + 1) // 2
    # Pin the impl: key_data is fed straight to threefry_2x32 below, which
    # needs a (2,) uint32 key. Under jax_default_prng_impl=rbg the default
    # key_data is (4,) and the stream would break; an explicit impl makes the
    # draw table independent of global config.
    base = jax.random.key(seed, impl="threefry2x32")
    keypairs = jax.vmap(
        lambda u: jax.random.key_data(jax.random.fold_in(base, u)))(uid)  # (W, 2)
    cnt = jnp.concatenate([
        jnp.arange(0, 2 * n_blocks, 2, dtype=jnp.uint32),
        jnp.arange(1, 2 * n_blocks, 2, dtype=jnp.uint32)])
    out = jax.vmap(lambda kp: threefry_2x32(kp, cnt))(keypairs)  # (W, 2B)
    w = out.shape[0]
    bits = jnp.stack([out[:, :n_blocks], out[:, n_blocks:]], axis=2)
    return jnp.transpose(bits.reshape(w, 2 * n_blocks)[:, :max_steps])  # (S, W)


def _sum_steps_f32(vals: jax.Array) -> jax.Array:
    """(W, S) float32 -> (W,) sum folded left to right over the step axis.

    A fixed order, not jnp.sum: a reduce's association order is the backend's
    choice (the GPU reduces as a tree), and representative selection ranks walks
    by this sum, so its rounding must not depend on where the walk ran. Step order
    is also walk/oracle.py's accumulation order."""
    acc = vals[:, 0]
    for s in range(1, vals.shape[1]):
        acc = acc + vals[:, s]
    return acc


def mc_weights(es: np.ndarray) -> np.ndarray:
    """Integer Monte-Carlo sampling weights from ES scores.

    weight = ceil(ES) for ES > 0 (so any positive score keeps >= 1), else 0.
    ES is in bp units (typically 100s-1000s), so the <= 1-unit quantisation error is
    < 0.1% relative — and integer weights make the sampling cumsum EXACT and
    order-independent, so MC decisions are bit-reproducible across backends and
    reduce orders (SURVEY.md §7 determinism hard part)."""
    es = np.asarray(es, np.float32)
    return np.where(es > 0, np.maximum(np.ceil(es), 1), 0).astype(np.int32)


class PlanDev(NamedTuple):
    start: jax.Array       # (W,) int32
    first_edge: jax.Array  # (W,) int32
    mode: jax.Array        # (W,) int32
    uid: jax.Array         # (W,) int32
    active: jax.Array      # (W,) bool


class WalkResult(NamedTuple):
    """Fixed-shape walk records (SURVEY.md §3 row 10)."""

    nodes: jax.Array      # (W, S+1) int32, -1 pad; [:, 0] is the start anchor
    eids: jax.Array       # (W, S) int32 edge ids taken, -1 pad
    steps: jax.Array      # (W,) int32 edges taken
    success: jax.Array    # (W,) bool reached another anchor
    terminal: jax.Array   # (W,) int32 terminal anchor node or -1
    path_len: jax.Array   # (W,) int32 sum of edge advances (bp)
    score_sum: jax.Array  # (W,) f32 sum of edge ES

    def to_numpy(self) -> "WalkResult":
        return WalkResult(*[np.asarray(a) for a in self])


def _cum_arrays(g: GraphTensors) -> np.ndarray:
    if g.cumw is not None:
        return g.cumw
    return np.cumsum(mc_weights(g.es), axis=1, dtype=np.int64).astype(np.int32)


def lane_width(k: int) -> int:
    """Padded CSR half-width H: smallest of 64, 128, 256, ... >= k (module
    docstring: a shape choice from the previous accelerator, kept until
    measured on the GPU)."""
    h = 64
    while h < k:
        h *= 2
    return h


def _pad_cols(a: np.ndarray, h: int, fill) -> np.ndarray:
    if a.shape[1] == h:
        return a
    pad = np.broadcast_to(fill, (a.shape[0], h - a.shape[1])).astype(a.dtype)
    return np.concatenate([a, pad], axis=1)


def pack_wide(nbr, cumw, eid, adv, es, os_, h: int) -> np.ndarray:
    """Pack the (N, K) CSR tables into the (N, 6H) wide row (GraphDev docstring).
    cum pads carry the row total: compare-count (#{cum <= r}, r < total) never
    lands on them, and a zero-total row stays dead."""
    cum_pad = _pad_cols(cumw, h, 0)
    if h != cumw.shape[1]:
        cum_pad = cum_pad.copy()
        cum_pad[:, cumw.shape[1]:] = cumw[:, -1:] if cumw.shape[1] else 0
    return np.concatenate([
        _pad_cols(nbr, h, -1).astype(np.int32),
        cum_pad.astype(np.int32),
        _pad_cols(eid, h, -1).astype(np.int32),
        _pad_cols(adv, h, 0).astype(np.int32),
        _pad_cols(es, h, 0.0).astype(np.float32).view(np.int32),
        _pad_cols(os_, h, 0.0).astype(np.float32).view(np.int32),
    ], axis=1)


def device_table_bytes(g: GraphTensors) -> int:
    """Device footprint of the packed walk table (wide 6H int32) — what
    graph_to_device will allocate. Used by the auto placement decision
    (pipeline.py: replicated vs rowshard)."""
    n = g.nbr.shape[0]
    h = lane_width(g.nbr.shape[1])
    return n * 6 * h * 4


def graph_to_device(g: GraphTensors, sharding=None) -> GraphDev:
    put = (lambda a: jax.device_put(a, sharding)) if sharding is not None else jax.device_put
    h = lane_width(g.nbr.shape[1])
    return GraphDev(
        wide=put(pack_wide(g.nbr, _cum_arrays(g), g.eid, g.adv, g.es, g.os_, h)),
    )


def plan_to_device(p: WalkPlan, sharding=None) -> PlanDev:
    put = (lambda a: jax.device_put(a, sharding)) if sharding is not None else jax.device_put
    return PlanDev(start=put(p.start), first_edge=put(p.first_edge), mode=put(p.mode),
                   uid=put(p.uid), active=put(p.active))


@functools.partial(jax.jit, static_argnames=("max_steps",))
def _run_walks_mc_fast(
    g: GraphDev, p: PlanDev, seed, *, n_anchors, max_steps: int
) -> WalkResult:
    """Local-gather wrapper over _mc_fast_core (see there for the algorithm)."""
    return _mc_fast_core(
        lambda cur: g.wide[cur], int(g.wide.shape[0]), g.h, p, seed,
        n_anchors=n_anchors, max_steps=max_steps)


def _mc_fast_core(
    fetch_rows, n_nodes: int, h: int, p: PlanDev, seed, *, n_anchors,
    max_steps: int,
):
    """Historyless MC scan + post-hoc event resolution (the 97%-of-batch hot path).

    fetch_rows(cur) -> (W, 6H) wide rows: a plain local gather for the replicated
    graph (g.wide[cur]) or a collective fetch for the row-sharded >HBM mode
    (dist/rowshard.py: all_gather(cur) + masked local gather + psum_scatter —
    exact, since exactly one shard contributes a nonzero row). n_nodes is the
    GLOBAL row count (the local table may be a shard).

    MC draws depend ONLY on (cur, uid, step) — the row CDF is static and revisits
    KILL rather than reroute — so the scan needs no visited table: its carry is just
    `cur` (W,), each step is one (W, 6H) wide-row gather, an in-register draw, and
    in-register lane reduces for the chosen slot's nxt/eid/adv/es; everything
    streams out through scan's stacked outputs (contiguous writes). Walks run PAST
    their terminal event; the first event — dead row (total <= 0), revisit (cycle
    kill), or anchor hit — is found afterwards with vectorized masking over the
    (W, S) records (_resolve_mc_events), and everything beyond it is masked off.
    Removing the in-scan visited carry ((W, S+1) dynamic-update-slice + revisit
    compare per serial step) and folding the attrs into the row gather (vs a
    separate (W, S) recon gather) were both faster on the previous
    accelerator. Event precedence matches the in-scan engine bit-for-bit:
    dead/revisit kill before an anchor hit at the same step counts
    (tests/test_walk.py sectioned≡mixed, engine≡oracle).

    (A TWO-PHASE variant — scan s1 steps for all walks, continue only the
    unresolved — existed rounds 2-4. Its final, fully-on-device form
    (jnp.nonzero compaction + lax.cond fallback, zero host syncs) was slower
    than this one-phase scan on the previous accelerator on every graph class
    measured (compaction + scatter-back overhead exceeded the saved gathers),
    and was removed.)"""
    w = p.start.shape[0]
    all_bits = _stable_bits_table(seed, p.uid, max_steps)       # (S, W)

    lane = jax.lax.broadcasted_iota(jnp.int32, (w, h), 1)

    def step(cur, bits):
        rows = fetch_rows(cur)                         # (W, 6H) ONE row gather
        cum_rows = rows[:, h:2 * h]
        total = cum_rows[:, -1]
        r = (bits & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32) % jnp.maximum(total, 1)
        choice = jnp.minimum(
            jnp.sum((cum_rows <= r[:, None]).astype(jnp.int32), axis=1), h - 1
        ).astype(jnp.int32)
        # one-hot lane reduces, NOT take_along_axis: a per-row dynamic pick would
        # lower to a second scattered gather per step
        sel = lane == choice[:, None]
        pick = lambda a: jnp.sum(jnp.where(sel, a, 0), axis=1)
        nxt = pick(rows[:, :h])
        attrs = (pick(rows[:, 2 * h:3 * h]), pick(rows[:, 3 * h:4 * h]),
                 pick(rows[:, 4 * h:5 * h]))           # eid, adv, es_bits
        return jnp.where(nxt >= 0, nxt, cur), (nxt, total, *attrs)

    _, (nxt_t, tot_t, eid_t, adv_t, es_t) = jax.lax.scan(
        step, p.start, all_bits, unroll=4)
    return _resolve_mc_events(
        p, jnp.transpose(nxt_t), jnp.transpose(tot_t), jnp.transpose(eid_t),
        jnp.transpose(adv_t), jnp.transpose(es_t), n_nodes=n_nodes,
        n_anchors=n_anchors, max_steps=max_steps)


def _resolve_mc_events(
    p: PlanDev, nxts, totals, eids_new, adv_new, es_bits_new, *,
    n_nodes: int, n_anchors, max_steps: int,
):
    """Post-hoc MC event resolution over (W, S) per-step records.

    The lax.scan engine (_mc_fast_core) streams out per-step
    (nxt, total, eid, adv, es_bits) records; the first event — dead row,
    revisit (cycle kill), or anchor hit — is found here with vectorized
    masking."""
    w = p.start.shape[0]
    anchor_lim = 2 * jnp.asarray(n_anchors, jnp.int32)
    eids_steps = eids_new                              # (W, S) per-step records
    adv_steps = adv_new
    es_steps = jax.lax.bitcast_convert_type(es_bits_new, jnp.float32)

    # post-hoc event resolution (all (W, S)-vectorized, no serial dependence):
    # the walk's node sequence is [start, ..new nxts]; for steps before the
    # first event it matches the in-scan engine's visited list exactly
    seq = jnp.concatenate([p.start[:, None], nxts], axis=1)        # (W, S+1)
    steps_i = jax.lax.broadcasted_iota(jnp.int32, (w, max_steps), 1)
    big = jnp.int32(max_steps + 1)
    first_true = lambda m: jnp.min(jnp.where(m, steps_i, big), axis=1)  # (W,)
    # revisit: a step's destination equals any EARLIER sequence entry. Pack
    # (node, seq idx) into one int32 and SORT each walk's sequence: duplicates
    # land adjacent, and the larger of an adjacent-equal pair carries the kill
    # index. The O(S log^2 S) sort beat the O(S^2) pairwise broadcast at S=32
    # on the previous accelerator. Entries from steps after t_dead are -1
    # (dead rows): they only duplicate each other, at indices > t_dead, so
    # t_kill's min() is unaffected.
    mult = 64
    while mult < max_steps + 1:
        mult *= 2
    if n_nodes * mult < 2**31:
        packed = jnp.sort(seq * mult + jax.lax.broadcasted_iota(
            jnp.int32, (w, max_steps + 1), 1), axis=1)
        adj_eq = (packed[:, 1:] // mult) == (packed[:, :-1] // mult)
        later = packed[:, 1:] % mult                   # seq idx of the 2nd of a pair
        # seq idx t+1 duplicates an earlier entry <=> step t stepped onto a revisit
        t_rev = jnp.min(jnp.where(adj_eq, later, big + 1), axis=1) - 1
    else:  # node*mult would overflow int32 (> ~33M oriented nodes): pairwise path
        # step i (writing seq index i+1) revisits seq index j iff j <= i
        tri = (jax.lax.broadcasted_iota(jnp.int32, (max_steps, max_steps + 1), 1)
               <= jax.lax.broadcasted_iota(jnp.int32, (max_steps, max_steps + 1), 0))
        dup = ((nxts[:, :, None] == seq[:, None, :]) & tri[None]).any(-1)  # (W, S)
        t_rev = first_true(dup)
    t_dead = first_true(totals <= 0)
    t_kill = jnp.minimum(jnp.where(p.active, big, 0), jnp.minimum(t_rev, t_dead))
    t_anchor = first_true(nxts < anchor_lim)
    success = t_anchor < t_kill                        # kill at the same step wins
    n_taken = jnp.where(success, t_anchor + 1, jnp.minimum(t_kill, max_steps))
    terminal = jnp.where(
        success, jnp.take_along_axis(
            nxts, jnp.clip(t_anchor, 0, max_steps - 1)[:, None], 1)[:, 0], -1)

    took = steps_i < n_taken[:, None]                  # (W, S)
    nodes = jnp.concatenate([p.start[:, None], jnp.where(took, nxts, -1)], axis=1)
    eids = jnp.where(took, eids_steps, -1)
    path_len = jnp.sum(jnp.where(took, adv_steps, 0), axis=1, dtype=jnp.int32)
    score_sum = _sum_steps_f32(jnp.where(took, es_steps, 0.0))

    return WalkResult(nodes=nodes, eids=eids, steps=n_taken, success=success,
                      terminal=terminal, path_len=path_len, score_sum=score_sum)


@functools.partial(jax.jit, static_argnames=("max_steps", "kind"))
def _run_walks_kind(
    g: GraphDev, p: PlanDev, seed, *, n_anchors, max_steps: int, kind: str
) -> WalkResult:
    """One lockstep scan, specialized by batch kind.

    kind="mixed": any modes (generic; used by tests and ad-hoc plans).
    kind="mc": all walks are Monte-Carlo with first_edge == -1 — delegates to the
      historyless _run_walks_mc_fast scan (the 97%-of-batch fast path).
    kind="greedy": no RNG at all — skips key folding and categorical.

    n_anchors is a TRACED scalar (not static): with bucketed batch/table shapes
    (utils/shapes.py) one compiled program serves every same-bucket dataset.
    """
    if kind == "mc":
        return _run_walks_mc_fast(g, p, seed, n_anchors=n_anchors,
                                  max_steps=max_steps)
    return _kind_core(
        lambda cur: g.wide[cur], g.h, p, seed,
        n_anchors=n_anchors, max_steps=max_steps, kind=kind)


def _kind_core(
    fetch_wide, h: int, p: PlanDev, seed, *,
    n_anchors, max_steps: int, kind: str
) -> WalkResult:
    """Mixed/greedy scan body, parameterized by the row fetch (see _mc_fast_core
    for the fetch contract). OS rides in the wide row's [5H:6H) block, so the
    greedy-OS selector needs no second fetch (advisor r2: row-sharded, a second
    fetch doubled the collective count per step)."""
    w = p.start.shape[0]
    k = h
    anchor_lim = 2 * jnp.asarray(n_anchors, jnp.int32)
    use_mc = kind in ("mixed", "mc")
    use_greedy = kind in ("mixed", "greedy")
    if use_mc:
        # hoist ALL RNG out of the scan: one batched (S, W) bits table of
        # fixed-counter draws on each walk's uid-folded key (_stable_bits_table) —
        # one threefry block per two draws (fold_in per step costs two blocks per
        # draw and measured 17x slower); the scan's serial critical path carries
        # no threefry hashing at all
        all_bits = _stable_bits_table(seed, p.uid, max_steps)  # (S, W)
    else:
        all_bits = jnp.zeros((max_steps, w), jnp.uint32)
    is_mc = p.mode == MODE_MC
    is_os = p.mode == MODE_GREEDY_OS

    visited0 = jnp.full((w, max_steps + 1), -1, jnp.int32).at[:, 0].set(p.start)
    carry0 = dict(
        cur=p.start,
        done=~p.active,
        success=jnp.zeros(w, bool),
        terminal=jnp.full(w, -1, jnp.int32),
        nsteps=jnp.zeros(w, jnp.int32),
        visited=visited0,
    )

    lane = jax.lax.broadcasted_iota(jnp.int32, (w, k), 1)

    def step(carry, inp):
        s, bits = inp
        cur = carry["cur"]
        rows = fetch_wide(cur)                          # (W, 6H) ONE contiguous row gather
        nbr_rows = rows[:, :k]

        if use_greedy:
            # greedy candidates exclude pads and already-visited destinations
            # (greedy REROUTES around its path; MC below kills instead)
            valid = nbr_rows >= 0
            revisit = (nbr_rows[:, :, None] == carry["visited"][:, None, :]).any(-1)
            valid &= ~revisit
            # greedy-ES: rows are ES-sorted, so the best candidate is the FIRST valid
            # slot; greedy-OS needs a masked argmax over OS. Merge: argmax over a
            # (W, K) key that is OS for mode-0 walks and a descending ramp otherwise.
            osb = jax.lax.bitcast_convert_type(rows[:, 5 * k:6 * k], jnp.float32)
            ramp = -jax.lax.broadcasted_iota(jnp.float32, (w, k), 1)
            gkey = jnp.where(is_os[:, None], osb, ramp)
            masked = jnp.where(valid, gkey, -jnp.inf)
            greedy_choice = jnp.argmax(masked, axis=1).astype(jnp.int32)
            greedy_dead = ~valid.any(axis=1)

        if use_mc:
            # Monte-Carlo: prob ∝ weight (mc_weights) over the STATIC row
            # distribution, sampled by integer inverse-CDF against the precomputed
            # row cumsum: gather the CONTIGUOUS (K,) cumsum row and count slots with
            # cum <= r (in-register compare-count = lower_bound for the first
            # cum > r). A draw landing on an already-visited destination KILLS the
            # walk (cycle kill, SURVEY.md §3 row 10) rather than rerouting.
            # r = bits % total has modulo bias <= total / 2^31 (< 0.01% on real
            # rows) — deterministic, replicated bit-for-bit by the oracle.
            cum_rows = rows[:, k:2 * k]                 # cumsum block of the same gather
            total = cum_rows[:, -1]
            r = (bits & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32) % jnp.maximum(total, 1)
            mc_choice = jnp.minimum(
                jnp.sum((cum_rows <= r[:, None]).astype(jnp.int32), axis=1), k - 1
            ).astype(jnp.int32)
            mc_dead = total <= 0

        if kind == "greedy":
            choice, dead = greedy_choice, greedy_dead
        else:
            choice = jnp.where(is_mc, mc_choice, greedy_choice)
            dead = jnp.where(is_mc, mc_dead, greedy_dead)

        if use_greedy:
            # deterministic first-edge enumeration (MC plans always have -1)
            forced = (s == 0) & (p.first_edge >= 0)
            choice = jnp.where(forced, p.first_edge, choice)

        # one-hot lane reduces (not take_along_axis — that would be a second
        # scattered gather per step): chosen slot's nxt/validity/eid/adv/es
        sel = lane == choice[:, None]
        pick = lambda a: jnp.sum(jnp.where(sel, a, 0), axis=1)
        nxt = pick(nbr_rows)

        if use_greedy:
            chosen_valid = jnp.sum(jnp.where(sel, valid, False), axis=1) > 0
            dead = jnp.where(forced, ~chosen_valid, dead)

        if use_mc:
            # MC cycle kill: chosen destination already on the path
            mc_revisit = (nxt[:, None] == carry["visited"]).any(-1)
            if kind == "mixed":
                dead = dead | (mc_revisit & is_mc)
            else:
                dead = dead | mc_revisit

        stepping = ~carry["done"] & ~dead
        hit_anchor = stepping & (nxt < anchor_lim)

        new = dict(
            cur=jnp.where(stepping, nxt, cur),
            done=carry["done"] | dead | hit_anchor,
            success=carry["success"] | hit_anchor,
            terminal=jnp.where(hit_anchor, nxt, carry["terminal"]),
            nsteps=carry["nsteps"] + stepping.astype(jnp.int32),
            visited=carry["visited"].at[:, s + 1].set(jnp.where(stepping, nxt, -1)),
        )
        attrs = (pick(rows[:, 2 * k:3 * k]), pick(rows[:, 3 * k:4 * k]),
                 pick(rows[:, 4 * k:5 * k]))           # eid, adv, es_bits
        return new, (stepping, *attrs)

    # unroll: XLA overlaps the per-step row gathers across unrolled iterations,
    # hiding gather latency behind compute (4 was best on the previous
    # accelerator)
    carry, (step_t, eid_t, adv_t, es_t) = jax.lax.scan(
        step, carry0, (jnp.arange(max_steps, dtype=jnp.int32), all_bits),
        unroll=4,
    )
    took = jnp.transpose(step_t)                   # (W, S) step actually taken
    eids = jnp.where(took, jnp.transpose(eid_t), -1)
    path_len = jnp.sum(jnp.where(took, jnp.transpose(adv_t), 0), axis=1,
                       dtype=jnp.int32)
    score_sum = _sum_steps_f32(jnp.where(
        took, jax.lax.bitcast_convert_type(jnp.transpose(es_t), jnp.float32), 0.0))

    return WalkResult(
        nodes=carry["visited"],
        eids=eids,
        steps=carry["nsteps"],
        success=carry["success"],
        terminal=carry["terminal"],
        path_len=path_len,
        score_sum=score_sum,
    )


def run_walks(
    g: GraphDev, p: PlanDev, seed, *, n_anchors: int, max_steps: int
) -> WalkResult:
    """Generic mixed-mode engine (any plan). Pure function of its inputs."""
    return _run_walks_kind(
        g, p, seed, n_anchors=n_anchors, max_steps=max_steps, kind="mixed")


def _slice_plan(p: WalkPlan, lo: int, hi: int) -> WalkPlan:
    return WalkPlan(start=p.start[lo:hi], first_edge=p.first_edge[lo:hi],
                    mode=p.mode[lo:hi], uid=p.uid[lo:hi], active=p.active[lo:hi])


def prepare_plan_sections(
    plan: WalkPlan, sharding=None
) -> list[tuple[str, PlanDev]]:
    """Slice a sectioned plan and upload each section to the device ONCE.

    The plan is static for a run; callers that launch walks repeatedly on the same
    plan (benchmarks, multi-seed sweeps) should prepare once and loop
    run_walks_prepared instead of re-uploading the (W,)x5 plan arrays per call."""
    if plan.sections is None:
        return [("mixed", plan_to_device(plan, sharding))]
    out = []
    for kind in ("greedy", "mc"):
        lo, hi = plan.sections[kind]
        if hi > lo:
            out.append((kind, plan_to_device(_slice_plan(plan, lo, hi), sharding)))
    return out


@functools.partial(jax.jit, static_argnames=("max_steps", "kinds"))
def _run_walks_multi(
    g: GraphDev, pds: tuple, seed, *, n_anchors, max_steps: int, kinds: tuple
) -> WalkResult:
    """All sections + the row-order concat under ONE jit: a single device dispatch
    per launch."""
    parts = [
        _run_walks_kind(g, pd, seed, n_anchors=n_anchors, max_steps=max_steps,
                        kind=kind)
        for kind, pd in zip(kinds, pds)
    ]
    if len(parts) == 1:
        return parts[0]
    return WalkResult(*[jnp.concatenate(a, axis=0) for a in zip(*parts)])


def run_walks_prepared(
    g: GraphDev, sections: list[tuple[str, PlanDev]], seed, *,
    n_anchors: int, max_steps: int,
) -> WalkResult:
    """Run device-resident plan sections (see prepare_plan_sections): one
    specialized scan per section, results concatenated back into plan row order.
    Bit-identical to run_walks on the same rows (same per-walk op order; uid-keyed
    RNG)."""
    if not sections:  # graph with no walkable anchor ends
        z = lambda *shape: jnp.zeros(shape, jnp.int32)
        return WalkResult(nodes=z(0, max_steps + 1), eids=z(0, max_steps),
                          steps=z(0), success=jnp.zeros(0, bool), terminal=z(0),
                          path_len=z(0), score_sum=jnp.zeros(0, jnp.float32))
    return _run_walks_multi(
        g, tuple(pd for _, pd in sections), seed, n_anchors=n_anchors,
        max_steps=max_steps, kinds=tuple(kind for kind, _ in sections))


def run_walks_sectioned(
    g: GraphDev, plan: WalkPlan, seed, *, n_anchors: int, max_steps: int,
    sharding=None,
) -> WalkResult:
    """prepare_plan_sections + run_walks_prepared in one shot (single-run callers)."""
    return run_walks_prepared(
        g, prepare_plan_sections(plan, sharding), seed,
        n_anchors=n_anchors, max_steps=max_steps)


def _slice_plan_padded(p: WalkPlan, lo: int, hi: int, w: int) -> WalkPlan:
    """Slice [lo, hi) then pad to w rows by repeating the last row INACTIVE.

    Padding is inert: draws depend only on (seed, uid, step) and the caller
    drops rows past hi-lo before concatenating, so padded output is bitwise
    identical to an exact slice — the same invariant build_rescue_plan uses."""
    rows = np.arange(lo, lo + w)
    idx = np.minimum(rows, hi - 1)
    return WalkPlan(start=p.start[idx], first_edge=p.first_edge[idx],
                    mode=p.mode[idx], uid=p.uid[idx],
                    active=p.active[idx] & (rows < hi), sections=None)


def run_walks_chunked(
    gd: GraphDev, plan: WalkPlan, seed, *, n_anchors: int, max_steps: int,
    max_batch: int,
) -> WalkResult:
    """Run a plan in deterministic device-dispatch chunks of <= max_batch rows.

    Records are uid-keyed (the core RNG invariant: draws depend only on
    (seed, uid, step)), so chunked output is BITWISE identical to one full
    dispatch — this is what bounds the walk stage's device memory at genome
    scale (config.max_walk_batch). Chunks split WITHIN each plan section (each
    chunk still runs the section's specialized scan), and results land in host
    numpy chunk by chunk, so device memory holds one chunk at a time.

    ONE COMPILED SHAPE per section kind (VERDICT r4 weak 2 / next-3): in a
    multi-chunk section the TAIL chunk is padded to max_batch with inactive
    repeat rows and the pad rows dropped from its records — the round-4
    exact-tail slice compiled one extra program per non-dividing section
    length. A section that fits in a single dispatch keeps its exact
    (bucketed) shape."""
    sections = (plan.sections or {None: (0, len(plan))}).items()
    parts: list[WalkResult] = []
    for kind, (lo, hi) in sorted(sections, key=lambda kv: kv[1][0]):
        multi = hi - lo > max_batch
        pos = lo
        while pos < hi:
            end = min(pos + max_batch, hi)
            keep = end - pos
            sub = (_slice_plan_padded(plan, pos, hi, max_batch) if multi
                   else _slice_plan(plan, pos, end))
            if kind == "mc":
                res = _run_walks_mc_fast(gd, plan_to_device(sub), seed,
                                         n_anchors=n_anchors,
                                         max_steps=max_steps)
            else:
                res = _run_walks_kind(gd, plan_to_device(sub), seed,
                                      n_anchors=n_anchors, max_steps=max_steps,
                                      kind=kind or "mixed")
            res = res.to_numpy()
            if len(sub) != keep:
                res = WalkResult(*[a[:keep] for a in res])
            parts.append(res)
            pos = end
    return WalkResult(*[np.concatenate(a, axis=0) for a in zip(*parts)])


def run_walks_host(
    g: GraphTensors, plan: WalkPlan, cfg: ScaffoldConfig
) -> WalkResult:
    """Single-device convenience wrapper (numpy in, numpy out).

    Plans larger than cfg.max_walk_batch run in deterministic chunks
    (run_walks_chunked) so the records + scan temps of a genome-scale batch
    never exceed one device's memory; smaller plans keep the single-dispatch
    path."""
    gd = graph_to_device(g)
    if 0 < cfg.max_walk_batch < len(plan):
        return run_walks_chunked(
            gd, plan, cfg.mc_seed, n_anchors=g.n_anchors,
            max_steps=cfg.max_steps, max_batch=cfg.max_walk_batch)
    res = run_walks_sectioned(
        gd, plan, cfg.mc_seed,
        n_anchors=g.n_anchors, max_steps=cfg.max_steps,
    )
    return res.to_numpy()
