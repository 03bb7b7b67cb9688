"""Path grouping + consensus selection as sort/segment reductions (device).

Reference parity: the C++ reference's PathGroup histogram/consensus logic (SURVEY.md §3
rows 11-12; mount empty, SURVEY.md §0 — rules below are OUR normative spec, following
HERA's length-histogram grouping).

Normative rules (deterministic, host-count-invariant — SURVEY.md §7):
  1. Only successful walks participate.
  2. A walk from anchor-end a to terminal b represents the UNDIRECTED bridge
     {a->b, rc(b)->rc(a)}; its canonical pair is the lexicographic min of
     (a, b) and (b^1, a^1).
  3. Walks of a pair are grouped by path length (path_len in bp, >= 0 since every
     edge advance is positive). Two modes (ScaffoldConfig.grouping):
       - "windowed" (default; HERA's sparse-region split, SURVEY.md §3 row 11):
         sort the pair's path lengths ascending and split between consecutive
         walks whose lengths differ by MORE than group_window — groups are the
         maximal runs with adjacent gaps <= group_window. A true length cluster
         is never split by an arbitrary bucket edge (the round-1 fixed-bucket
         failure mode).
       - "fixed": bucket = path_len // group_window (round-1 behavior, kept for
         comparability).
  4. The winning group per pair is the most-populated group; ties break to the
     group with the SMALLER minimal path length (shorter bridge).
  5. The representative of the winning group is its max score_sum walk; exact ties
     break to the smaller walk uid.
  6. A pair yields a bridge only if the winning group holds >= min_group_support
     SUPPORT units. Two support modes (ScaffoldConfig.support_mode):
       - "read_diverse" (default since round 4): the EVIDENCE GATE counts
         DISTINCT paths in the winning group, where a path's identity is
         (path_len, canonical interior signature) — see path_signature. Walk
         COUNT is density-inflated (doubling mc_walks_per_end doubles every
         count, real or chimeric), so it cannot GATE safely at high walk
         density; distinct-path support is density-INVARIANT: more walks can
         only discover new paths, never inflate existing ones (the
         rescue-round argument, walk/rescue.py round 3, now normative for the
         base round). The companion cut-read gate (consensus/evidence.py)
         additionally refuses a pair whose distinct paths all share one read.
         Rules 4 (winner group) and the conflict-resolution ORDERING
         (bridge.py rule 1) still use the RAW walk count: count is the
         sampling-probability signal — within one run every pair runs at the
         same density, and the shortest/highest-score TRUE path draws more
         walks than any wrong-copy alternative. Measured on hg002-sub at
         1000 walks/end: ordering by DISTINCT count instead let two
         diversity-rich wrong-copy webs (389- and 873-walk true pairs beaten
         by many-distinct-path fakes) claim ends — diversity is evidence of
         READ support, not of being the RIGHT bridge.
       - "walk_count": raw successful-walk count everywhere (rounds 1-3
         behavior; only sound at low, comparable densities).

ConsensusResult.bucket reports the winning group's key: its minimal path length
(windowed) or its bucket index (fixed).

Implementation: lexicographic (pair, bucket) ordering via chained stable argsorts +
fixed-shape segment reductions — O(W log W), no dense (pairs x buckets) histogram, so it
scales to genome-size anchor counts (SURVEY.md §2.2 `consensus/`). int32-only on device
(JAX x64 is off). Runs identically on every host after walk summaries are all-gathered
(dist/).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_I32MAX = jnp.iinfo(jnp.int32).max


class WalkSummary(NamedTuple):
    """The per-walk fields consensus needs (device; this is what dist/ all-gathers)."""

    start: jax.Array      # (W,) int32
    terminal: jax.Array   # (W,) int32
    success: jax.Array    # (W,) bool
    path_len: jax.Array   # (W,) int32
    score_sum: jax.Array  # (W,) f32
    uid: jax.Array        # (W,) int32
    # (W,) uint32 canonical interior-path signature (path_signature), or None
    # when the summary was built without walk records (legacy "walk_count" mode)
    sig: jax.Array | None = None


class ConsensusResult(NamedTuple):
    """Per-segment outputs, fixed shape (W,); rows with valid=False are padding.

    Each valid row is one selected bridge: canonical pair (a, b), its winning-bucket
    support count, the representative walk's uid and score.
    """

    valid: jax.Array      # (W,) bool
    pair_a: jax.Array     # (W,) int32 canonical start anchor-end
    pair_b: jax.Array     # (W,) int32 canonical terminal anchor-end
    count: jax.Array      # (W,) int32 winning-group RAW walk count
    bucket: jax.Array     # (W,) int32 winning length bucket
    rep_uid: jax.Array    # (W,) int32 representative walk uid
    rep_score: jax.Array  # (W,) f32 representative walk score_sum
    # (W,) int32 winning-group DISTINCT-path count (the rule-6 gate unit in
    # "read_diverse" mode); None in "walk_count" mode
    distinct: jax.Array | None = None
    # (W,) bool in ORIGINAL WALK ORDER (not segment order like the fields above):
    # marks one walk per distinct path of each min_support-passing winning group —
    # the rows the cut-read gate (consensus/evidence.py) must inspect. None in
    # "walk_count" mode.
    win_distinct: jax.Array | None = None

    def to_numpy(self) -> "ConsensusResult":
        return ConsensusResult(
            *[None if a is None else np.asarray(a) for a in self])


@jax.jit
def path_signature(nodes: jax.Array, steps: jax.Array,
                   virtual_base: jax.Array) -> jax.Array:
    """(W,) uint32 canonical signature of each walk's INTERIOR path.

    Interior = nodes[1:steps] (the reads between the start anchor and the
    terminal anchor), EXCLUDING hierarchy hop nodes (>= virtual_base —
    graph/tensorize.py: a hub row chained through virtual children walks the
    same physical path as a flat row would). The signature is a COMMUTATIVE
    sum of a murmur3-finalizer mix of each interior node id, canonicalized
    under direction reversal by min(fwd, mirror): the reverse-complement walk
    of the same physical path visits the SAME node set with orientations
    flipped (^1), so summing mix(node^1) reproduces its forward signature
    exactly — both directions of one path share one signature.

    Commutativity means two DIFFERENT paths visiting the same node multiset in
    different orders collide; combined with the (path_len, sig) distinct key in
    group_and_select that requires identical length too, and the consequence
    being an UNDER-count of distinct support (conservative: refuses, never
    fabricates evidence), this is an accepted approximation. virtual_base is a
    TRACED scalar so one compiled program serves every dataset.
    """
    w, sp1 = nodes.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, (w, sp1), 1)
    interior = ((ii >= 1) & (ii < steps[:, None])
                & (nodes >= 0) & (nodes < virtual_base))

    def mix(x):  # murmur3 fmix32 (bijective on uint32; +1 keeps node 0 nonzero)
        x = (x + 1).astype(jnp.uint32)
        x ^= x >> 16
        x *= jnp.uint32(0x85EBCA6B)
        x ^= x >> 13
        x *= jnp.uint32(0xC2B2AE35)
        x ^= x >> 16
        return x

    zero = jnp.uint32(0)
    fwd = jnp.sum(jnp.where(interior, mix(nodes), zero), axis=1, dtype=jnp.uint32)
    mir = jnp.sum(jnp.where(interior, mix(nodes ^ 1), zero), axis=1,
                  dtype=jnp.uint32)
    return jnp.minimum(fwd, mir)


def summarize(res, uid, virtual_base: int | None = None) -> WalkSummary:
    """WalkResult -> WalkSummary (start is nodes[:, 0]).

    Pass virtual_base (GraphTensors.virtual_base) to compute per-walk path
    signatures — required for support_mode="read_diverse" grouping."""
    sig = (None if virtual_base is None
           else path_signature(res.nodes, res.steps,
                               jnp.asarray(virtual_base, jnp.int32)))
    return WalkSummary(
        start=res.nodes[:, 0], terminal=res.terminal, success=res.success,
        path_len=res.path_len, score_sum=res.score_sum, uid=uid, sig=sig,
    )


def _lexsort_rows(keys_minor_to_major):
    """Stable argsort by several int32 keys (last = most significant), numpy.lexsort-style."""
    order = jnp.argsort(keys_minor_to_major[0], stable=True)
    for k in keys_minor_to_major[1:]:
        order = order[jnp.argsort(k[order], stable=True)]
    return order


@functools.partial(jax.jit, static_argnames=("group_window", "min_support",
                                             "grouping", "support"))
def group_and_select(
    s: WalkSummary, *, n_anchors: int = 0, group_window: int, min_support: int,
    grouping: str = "windowed", support: str = "walk_count",
) -> ConsensusResult:
    # n_anchors is accepted for API symmetry but unused by the math (canonical
    # pairs + segment reductions never need it); it is deliberately NOT a static
    # jit arg, so one compiled consensus program serves every dataset of the same
    # walk-batch bucket (utils/shapes.py).
    if grouping not in ("windowed", "fixed"):
        raise ValueError(f"grouping must be windowed/fixed, got {grouping!r}")
    if support not in ("walk_count", "read_diverse"):
        raise ValueError(
            f"support must be walk_count/read_diverse, got {support!r}")
    diverse = support == "read_diverse"
    if diverse and s.sig is None:
        raise ValueError("support='read_diverse' needs path signatures: build "
                         "the summary with summarize(res, uid, virtual_base)")
    w = s.start.shape[0]
    if w == 0:  # no walks at all (e.g. empty PAF): nothing to group
        zi = jnp.zeros(0, jnp.int32)
        return ConsensusResult(
            valid=jnp.zeros(0, bool), pair_a=zi, pair_b=zi, count=zi, bucket=zi,
            rep_uid=zi, rep_score=jnp.zeros(0, jnp.float32),
            distinct=zi if diverse else None,
            win_distinct=jnp.zeros(0, bool) if diverse else None)

    a = s.start.astype(jnp.int32)
    b = s.terminal.astype(jnp.int32)
    # canonical undirected pair: min((a,b), (b^1, a^1)) lexicographic (rule 2)
    ra, rb = b ^ 1, a ^ 1
    flip = (ra < a) | ((ra == a) & (rb < b))
    ca = jnp.where(flip, ra, a)
    cb = jnp.where(flip, rb, b)

    plen = s.path_len.astype(jnp.int32)
    # rule 3: the in-pair sort/group key is the bucket index (fixed) or the raw
    # path length (windowed — groups are found by gap-splitting the sorted runs)
    key = plen // group_window if grouping == "fixed" else plen
    valid = s.success
    # invalid rows sort to the very end
    ca = jnp.where(valid, ca, _I32MAX)
    cb = jnp.where(valid, cb, _I32MAX)
    key_k = jnp.where(valid, key, _I32MAX)

    # read_diverse adds (path_len, sig) as MINOR sort keys so duplicate records
    # of one physical path land adjacent within their group — path_len
    # explicitly, because in "fixed" grouping key is the bucket index, not the
    # length, and the distinct unit is (path_len, sig) in both modes. Their
    # ordering is arbitrary (only equality matters), so no sentinels needed.
    keys = ([s.sig, plen, key_k, cb, ca] if diverse else [key_k, cb, ca])
    order = _lexsort_rows(keys)
    ca_s, cb_s, key_s = ca[order], cb[order], key_k[order]
    valid_s = valid[order]
    score_s = s.score_sum[order]
    uid_s = s.uid[order]

    # segment = one length group within a pair; pair segment = (pair) run
    neq = lambda x: jnp.concatenate([jnp.ones(1, bool), x[1:] != x[:-1]])
    pair_first = neq(ca_s) | neq(cb_s)
    if grouping == "fixed":
        seg_first = pair_first | neq(key_s)
    else:
        # HERA sparse-region split: a new group starts where the ascending sorted
        # path lengths jump by MORE than group_window (adjacent-gap clustering)
        gap = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), key_s[1:] - key_s[:-1]]) > group_window
        seg_first = pair_first | gap
    seg_id = jnp.cumsum(seg_first.astype(jnp.int32)) - 1
    pair_id = jnp.cumsum(pair_first.astype(jnp.int32)) - 1

    ssum = lambda v: jax.ops.segment_sum(v, seg_id, num_segments=w)
    smax_seg = lambda v: jax.ops.segment_max(v, seg_id, num_segments=w)

    if diverse:
        # gate unit = distinct (path_len, sig): the first row of each
        # duplicate run inside its segment counts, the rest are re-samples of
        # the same physical path (rule 6 "read_diverse")
        sig_s = s.sig[order]
        plen_s = plen[order]
        distinct_first = seg_first | neq(plen_s) | neq(sig_s)
        unit_s = valid_s & distinct_first
        seg_distinct = ssum(unit_s.astype(jnp.int32))
    else:
        unit_s = valid_s
        seg_distinct = None
    seg_count = ssum(valid_s.astype(jnp.int32))   # RAW count: rules 1 + 4
    seg_pair = smax_seg(jnp.where(valid_s, pair_id, -1))          # pair id of each segment
    # group key for reporting + rule-4 tie-break: bucket index (fixed) or the
    # group's MINIMAL path length (windowed; = first sorted member). Both are
    # strictly increasing across a pair's groups, so "smaller key" = "shorter".
    seg_bucket = -smax_seg(jnp.where(valid_s, -key_s, -_I32MAX))
    seg_bucket = jnp.where(seg_count > 0, seg_bucket, -1)
    seg_ca = smax_seg(jnp.where(valid_s, ca_s, -1))
    seg_cb = smax_seg(jnp.where(valid_s, cb_s, -1))

    # winner per pair (rule 4): max count, tie -> smaller bucket; two-stage reduction
    pair_ix = jnp.maximum(seg_pair, 0)
    best_count = jax.ops.segment_max(seg_count, pair_ix, num_segments=w)
    at_best = (seg_count > 0) & (seg_count == best_count[pair_ix])
    win_bucket = jax.ops.segment_min(
        jnp.where(at_best, seg_bucket, _I32MAX), pair_ix, num_segments=w)
    seg_is_winner = at_best & (seg_bucket == win_bucket[pair_ix])

    # representative (rule 5): max score within the winning segment, tie -> min uid
    win_pos = valid_s & seg_is_winner[seg_id]
    smax = smax_seg(jnp.where(win_pos, score_s, -jnp.inf))
    best_pos = win_pos & (score_s == smax[seg_id])
    rep_uid = jax.ops.segment_min(
        jnp.where(best_pos, uid_s, _I32MAX), seg_id, num_segments=w)

    # rule 6: the gate unit is the distinct-path count in read_diverse mode
    gate = seg_distinct if diverse else seg_count
    out_valid = seg_is_winner & (gate >= min_support)
    if diverse:
        # one flag per distinct path of each min_support-passing winning group,
        # scattered back to ORIGINAL walk order for the cut-read gate
        row_win = unit_s & out_valid[seg_id]
        win_distinct = jnp.zeros(w, bool).at[order].set(row_win)
    else:
        win_distinct = None
    return ConsensusResult(
        valid=out_valid,
        pair_a=seg_ca,
        pair_b=seg_cb,
        count=seg_count,
        bucket=seg_bucket,
        rep_uid=rep_uid,
        rep_score=smax.astype(jnp.float32),
        distinct=seg_distinct,
        win_distinct=win_distinct,
    )


def oracle_interior_key(nodes_row, steps_i: int, virtual_base: int):
    """EXACT canonical interior-path key of one walk (the scalar mirror of
    path_signature's hashed one): min(interior, mirror) over the hop-stripped
    interior node tuple. Used by the oracle and the cut-read gate tests."""
    interior = tuple(int(x) for x in nodes_row[1:steps_i]
                     if 0 <= x < virtual_base)
    mirror = tuple(x ^ 1 for x in reversed(interior))
    return min(interior, mirror)


def consensus_oracle(
    s: WalkSummary, n_anchors: int, group_window: int, min_support: int,
    grouping: str = "windowed", support: str = "walk_count",
    nodes: np.ndarray | None = None, steps: np.ndarray | None = None,
    virtual_base: int | None = None,
) -> list[dict]:
    """Scalar python reference of rules 1-6 (tests/test_consensus.py parity).

    support="read_diverse" needs the walk records (nodes, steps, virtual_base)
    and counts distinct (path_len, exact canonical interior) per group — an
    independent, hash-free mirror of the device's (path_len, sig) key, so the
    parity test also certifies the hash has no collisions on its inputs."""
    by_pair: dict[tuple[int, int], list[int]] = {}
    start = np.asarray(s.start); term = np.asarray(s.terminal)
    succ = np.asarray(s.success); plen = np.asarray(s.path_len)
    score = np.asarray(s.score_sum); uid = np.asarray(s.uid)
    diverse = support == "read_diverse"
    if diverse and (nodes is None or steps is None or virtual_base is None):
        raise ValueError("read_diverse oracle needs nodes/steps/virtual_base")
    for i in range(len(start)):
        if not succ[i]:
            continue
        a, b = int(start[i]), int(term[i])
        cand = min((a, b), (b ^ 1, a ^ 1))
        by_pair.setdefault(cand, []).append(i)

    def n_units(walks: list[int]) -> int:
        if not diverse:
            return len(walks)
        return len({(int(plen[i]),
                     oracle_interior_key(nodes[i], int(steps[i]), virtual_base))
                    for i in walks})

    out = []
    for (a, b), members in sorted(by_pair.items()):
        # groups keyed by bucket index (fixed) or group min path length (windowed)
        if grouping == "fixed":
            buckets: dict[int, list[int]] = {}
            for i in members:
                buckets.setdefault(int(plen[i]) // group_window, []).append(i)
        else:
            members = sorted(members, key=lambda i: int(plen[i]))
            buckets = {}
            cur_key = None
            prev_len = None
            for i in members:
                li = int(plen[i])
                if prev_len is None or li - prev_len > group_window:
                    cur_key = li            # group's min length
                buckets.setdefault(cur_key, []).append(i)
                prev_len = li
        # rule 4 winner by RAW count; rule 6 gate by distinct units
        bk = min(buckets, key=lambda k: (-len(buckets[k]), k))
        walks = buckets[bk]
        if n_units(walks) < min_support:
            continue
        rep = min(walks, key=lambda i: (-score[i], uid[i]))
        row = dict(pair=(a, b), count=len(walks), bucket=bk,
                   rep_uid=int(uid[rep]), rep_score=float(score[rep]))
        if diverse:
            row["distinct"] = n_units(walks)
        out.append(row)
    return out


def compress(c: ConsensusResult) -> list[dict]:
    """Host-side: valid rows of a ConsensusResult as a sorted list of bridge dicts."""
    c = c.to_numpy()
    rows = []
    for i in np.flatnonzero(c.valid):
        row = dict(pair=(int(c.pair_a[i]), int(c.pair_b[i])),
                   count=int(c.count[i]), bucket=int(c.bucket[i]),
                   rep_uid=int(c.rep_uid[i]), rep_score=float(c.rep_score[i]))
        if c.distinct is not None:
            row["distinct"] = int(c.distinct[i])
        rows.append(row)
    rows.sort(key=lambda r: r["pair"])
    return rows
