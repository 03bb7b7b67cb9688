"""Per-gap bridge diagnosis on simulated datasets (VERDICT r2 item 4).

For a run whose contigs are in genome order (the simulator writes ctg000,
ctg001, ... left to right), every adjacent pair (c, c+1) is a ground-truth gap
the scaffolder should bridge. This tool replays consensus + conflict
resolution from the saved walk artifact and reports, for every UNBRIDGED gap,
exactly where the bridge was lost:

  no-walks        no plan rows left either flanking end (planner/graph issue)
  no-connection   walks ran but none connected the two flanking ends —
                  sub-classified by what they did instead (truncated at
                  max_steps / died mid-graph / landed on other anchors)
  low-support     a connecting length-group formed but count < min_group_support
  lost-consensus  connecting walks exist but a DIFFERENT (wrong-mate) group won
                  the pair's consensus, or the pair's winner is elsewhere
  lost-conflict   the pair's bridge was valid but conflict resolution rejected
                  it (its contig end was claimed by a stronger bridge / cycle)

Usage:
  python tools/gap_report.py RUNDIR   # expects RUNDIR/{graph.npz,walks.npz,
                                      #   out.config.json} from
                                      # scaffold --save-graph --save-walks
"""

from __future__ import annotations

import json
import os
import sys
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# host-side analysis: stays on the CPU and leaves the card to the pipeline
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def canonical_pair(a: int, b: int) -> tuple[int, int]:
    """Same canonicalization as consensus/grouping.py rule 2."""
    ra, rb = b ^ 1, a ^ 1
    return (ra, rb) if (ra, rb) < (a, b) else (a, b)


def diagnose(rundir: str, out=sys.stdout):
    from telomeri_tpu.config import ScaffoldConfig
    from telomeri_tpu.consensus.grouping import (
        compress, group_and_select, summarize)
    from telomeri_tpu.io.artifacts import load_graph, load_walks
    from telomeri_tpu.scaffold.bridge import (
        End, make_bridge, resolve_with_blockers, start_end, terminal_end)

    cfgp = sorted(f for f in os.listdir(rundir) if f.endswith(".config.json"))
    # machine-written run config: tolerant load (a future/removed field must
    # not block diagnosis); user typos aren't a concern here
    cfg = (ScaffoldConfig.from_json(
        open(os.path.join(rundir, cfgp[0])).read(), strict=False)
        if cfgp else ScaffoldConfig())
    edges, graph = load_graph(os.path.join(rundir, "graph.npz"), cfg)
    plan, walks = load_walks(os.path.join(rundir, "walks.npz"), cfg)
    n_c = graph.n_anchors

    summary = summarize(walks, plan.uid, virtual_base=graph.virtual_base)
    cons = group_and_select(
        summary, n_anchors=n_c, group_window=cfg.group_window,
        min_support=cfg.min_group_support, grouping=cfg.grouping,
        support=cfg.support_mode).to_numpy()
    rows = compress(cons)
    blocked_rows = []
    if cfg.support_mode == "read_diverse":
        from telomeri_tpu.consensus.evidence import read_diversity_gate

        rows, blocked_rows = read_diversity_gate(
            rows, cons, walks, graph.virtual_base,
            split_read=graph.split_read)
    if cfg.support_mode == "read_diverse" and cfg.copy_coherence_margin > 0:
        from telomeri_tpu.consensus.coherence import annotate_pair_coherence

        annotate_pair_coherence(rows, cons, walks, edges, graph.virtual_base,
                                cfg.copy_coherence_margin)
    accepted, _blocked_ends = resolve_with_blockers(rows, blocked_rows)
    acc_pairs = {b.pair for b in accepted}
    blocked_pair = {tuple(r["pair"]): r for r in blocked_rows}
    split_flags = (np.asarray(graph.split_read)
                   if graph.split_read is not None else None)
    end_owner: dict[End, tuple[int, int]] = {}
    for b in accepted:
        end_owner[b.end_a] = b.pair
        end_owner[b.end_b] = b.pair

    # ALL segments (valid or not) per pair, for the low-support/lost-consensus
    # distinction: (pair -> list of (count, bucket, winner, valid))
    seg_mask = cons.count > 0
    seg_by_pair: dict[tuple[int, int], list] = {}
    win_bucket = {}
    for i in np.flatnonzero(seg_mask):
        p = (int(cons.pair_a[i]), int(cons.pair_b[i]))
        seg_by_pair.setdefault(p, []).append(
            (int(cons.count[i]), int(cons.bucket[i]), bool(cons.valid[i])))
        if bool(cons.valid[i]):
            win_bucket[p] = int(cons.bucket[i])

    start = np.asarray(walks.nodes[:, 0])
    term = np.asarray(walks.terminal)
    succ = np.asarray(walks.success)
    steps = np.asarray(walks.steps)
    active = np.asarray(plan.active)

    def walks_leaving(end: End):
        u = 2 * end.contig + (0 if end.right else 1)
        return np.flatnonzero(active & (start == u))

    report = dict(n_contigs=n_c, n_gaps=n_c - 1, bridged=0, missed=[])
    for c in range(n_c - 1):
        pair = canonical_pair(2 * c, 2 * c + 2)   # gap c: (c)R -- (c+1)L
        if pair in acc_pairs:
            report["bridged"] += 1
            continue
        eR, eL = End(c, True), End(c + 1, False)
        diag = dict(gap=c, pair=pair)
        rowsL, rowsR = walks_leaving(eR), walks_leaving(eL)
        # a walk CONNECTS the gap if its (start, terminal) canonicalizes to pair
        conn = [i for i in np.concatenate([rowsL, rowsR])
                if succ[i] and canonical_pair(int(start[i]), int(term[i])) == pair]
        diag["n_walks"] = int(len(rowsL) + len(rowsR))
        diag["n_connecting"] = len(conn)
        if diag["n_walks"] == 0:
            diag["verdict"] = "no-walks"
            # out-degree of the two flanking oriented ends: 0/0 = coverage hole
            # (no read extends past either flank — correct non-bridge); nonzero
            # degrees with no walks = planner issue
            deg = np.asarray(graph.deg)
            diag["flank_out_degrees"] = {
                str(eR): int(deg[2 * c]), str(eL): int(deg[2 * (c + 1) + 1])}
        elif not conn:
            both = np.concatenate([rowsL, rowsR])
            n_trunc = int(((steps[both] >= cfg.max_steps) & ~succ[both]).sum())
            n_dead = int((~succ[both] & (steps[both] < cfg.max_steps)).sum())
            other = Counter()
            for i in both:
                if succ[i]:
                    e = terminal_end(int(term[i]))
                    other[f"{e.contig}{'R' if e.right else 'L'}"] += 1
            diag["verdict"] = "no-connection"
            diag["truncated_at_max_steps"] = n_trunc
            diag["died_mid_graph"] = n_dead
            diag["reached_other_anchors"] = dict(other.most_common(5))
        else:
            segs = seg_by_pair.get(pair, [])
            best = max((s[0] for s in segs), default=0)
            if pair in blocked_pair:
                # round 5 (the round-4 report mislabeled this as a cycle
                # rejection by elimination): the pair won its consensus but
                # the cut-read gate REFUSED it — every distinct path hangs on
                # cut read(s) that are split-mapped (chimera signature) or of
                # unknown mapping — and its ends were claimed as blockers
                # (deliberate, misjoin-safe refusal; consensus/evidence.py)
                r = blocked_pair[pair]
                cut = r.get("cut_reads", [])
                diag["verdict"] = "gate-refused"
                diag["cut_reads"] = cut
                if split_flags is not None:
                    diag["cut_reads_split_mapped"] = [
                        bool(split_flags[x]) for x in cut]
                diag["distinct_paths"] = int(r.get("distinct", r["count"]))
                diag["note"] = ("single-point evidence: all cut reads "
                                "split-mapped/unknown; ends blocked by design")
            elif pair in win_bucket:
                diag["verdict"] = "lost-conflict"
                owners = {str(e): end_owner.get(e) for e in (eR, eL)
                          if e in end_owner}
                diag["ends_claimed_by"] = {k: list(v) for k, v in owners.items()
                                           if v is not None}
                if not owners:
                    diag["note"] = ("pair valid in consensus but rejected by "
                                    "cycle rule (union-find)")
            elif best and best < cfg.min_group_support:
                diag["verdict"] = "low-support"
                diag["best_group_count"] = best
                diag["min_group_support"] = cfg.min_group_support
            else:
                diag["verdict"] = "lost-consensus"
                diag["segments"] = segs[:8]
        report["missed"].append(diag)

    json.dump(report, out, indent=1)
    out.write("\n")
    return report


if __name__ == "__main__":
    diagnose(sys.argv[1])
