"""Walk engine tests: semantics, determinism, and engine≡oracle parity
(SURVEY.md §5 items 2-3)."""

import numpy as np
import pytest

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.graph.tensorize import GraphTensors
from telomeri_tpu.walk.engine import graph_to_device, plan_to_device, run_walks
from telomeri_tpu.walk.oracle import fast_choice_fn, jax_choice_fn, walk_oracle
from telomeri_tpu.walk.plan import MODE_GREEDY_ES, MODE_GREEDY_OS, MODE_MC, WalkPlan, plan_walks


def mk_graph(n_nodes, n_anchors, k, rows):
    """rows: {src: [(dst, es, os, adv), ...]}"""
    nbr = np.full((n_nodes, k), -1, np.int32)
    es = np.zeros((n_nodes, k), np.float32)
    osb = np.zeros((n_nodes, k), np.float32)
    adv = np.zeros((n_nodes, k), np.int32)
    eid = np.full((n_nodes, k), -1, np.int32)
    e = 0
    for src, lst in rows.items():
        # engine contract: rows sorted by (ES desc, dst asc)
        lst = sorted(lst, key=lambda t: (-t[1], t[0]))
        for j, (dst, e_s, o_s, a) in enumerate(lst):
            nbr[src, j], es[src, j], osb[src, j], adv[src, j], eid[src, j] = dst, e_s, o_s, a, e
            e += 1
    deg = (nbr >= 0).sum(1).astype(np.int32)
    return GraphTensors(nbr=nbr, es=es, os_=osb, adv=adv, eid=eid, deg=deg,
                        seq_len=np.full(n_nodes // 2, 100, np.int32), n_anchors=n_anchors)


def mk_plan(starts, firsts, modes):
    n = len(starts)
    return WalkPlan(
        start=np.array(starts, np.int32), first_edge=np.array(firsts, np.int32),
        mode=np.array(modes, np.int32), uid=np.arange(n, dtype=np.int32),
        active=np.ones(n, bool),
    )


def run(g, p, seed=0, max_steps=8):
    return run_walks(graph_to_device(g), plan_to_device(p), seed,
                     n_anchors=g.n_anchors, max_steps=max_steps).to_numpy()


# anchors: contigs 0,1 -> nodes 0..3 ; reads -> nodes 4..
def chain_graph():
    # 0 -> 4 -> 6 -> 2 (anchor), plus dead-end 4 -> 8
    return mk_graph(10, 2, 4, {
        0: [(4, 10.0, 5.0, 100)],
        4: [(6, 8.0, 4.0, 200), (8, 1.0, 9.0, 50)],
        8: [],
        6: [(2, 6.0, 3.0, 300)],
    })


def test_greedy_es_reaches_anchor():
    g = chain_graph()
    r = run(g, mk_plan([0], [-1], [MODE_GREEDY_ES]))
    assert r.success[0] and r.terminal[0] == 2
    assert r.steps[0] == 3
    assert list(r.nodes[0][:4]) == [0, 4, 6, 2]
    assert r.path_len[0] == 600
    assert r.score_sum[0] == pytest.approx(24.0)
    assert list(r.eids[0][:3]) == [0, 1, 3]


def test_greedy_os_takes_other_branch_and_dies():
    g = chain_graph()  # at node 4, OS prefers dst 8 (os=9) which is a dead end
    r = run(g, mk_plan([0], [-1], [MODE_GREEDY_OS]))
    assert not r.success[0]
    assert list(r.nodes[0][:3]) == [0, 4, 8]
    assert r.steps[0] == 2


def test_first_edge_override():
    g = chain_graph()
    # at step 0 node 0 has only edge slot 0; slot 1 is invalid -> walk dies at once
    r = run(g, mk_plan([0, 0], [0, 1], [MODE_GREEDY_ES, MODE_GREEDY_ES]))
    assert r.success[0] and r.steps[1] == 0 and not r.success[1]


def test_cycle_kill():
    # 0 -> 4 -> 6 -> 4 cycle; revisit masked -> dies at 6 (only edge back to 4)
    g = mk_graph(8, 1, 2, {
        0: [(4, 5.0, 5.0, 10)],
        4: [(6, 5.0, 5.0, 10)],
        6: [(4, 5.0, 5.0, 10)],
    })
    r = run(g, mk_plan([0], [-1], [MODE_GREEDY_ES]))
    assert not r.success[0]
    assert r.steps[0] == 2
    assert list(r.nodes[0][:3]) == [0, 4, 6]


def test_inactive_walks_never_step():
    g = chain_graph()
    p = mk_plan([0, 0], [-1, -1], [MODE_GREEDY_ES, MODE_GREEDY_ES])
    p.active[1] = False
    r = run(g, p)
    assert r.success[0] and not r.success[1] and r.steps[1] == 0


def test_mc_seed_determinism_and_batch_invariance():
    g = chain_graph()
    p1 = mk_plan([0] * 4, [-1] * 4, [MODE_MC] * 4)
    r1 = run(g, p1, seed=7)
    r2 = run(g, p1, seed=7)
    np.testing.assert_array_equal(r1.nodes, r2.nodes)

    # embed the same uids in a bigger padded batch: per-uid results must not change
    p2 = mk_plan([0] * 16, [-1] * 16, [MODE_MC] * 16)
    p2.active[4:] = False
    p2.start[4:] = 0
    r3 = run(g, p2, seed=7)
    np.testing.assert_array_equal(r1.nodes, r3.nodes[:4])
    np.testing.assert_array_equal(r1.path_len, r3.path_len[:4])


def test_mc_distribution_follows_es():
    # node 0 -> {2 (anchor, es=9), 4 (read, es=1)}: ~90% of MC walks end at 2 in 1 step
    g = mk_graph(6, 2, 2, {0: [(2, 9.0, 1.0, 10), (4, 1.0, 1.0, 10)], 4: []})
    n = 500
    p = mk_plan([0] * n, [-1] * n, [MODE_MC] * n)
    r = run(g, p, seed=3)
    frac = (r.nodes[:, 1] == 2).mean()
    assert 0.85 < frac < 0.95


def random_graph(rng, n_seqs=40, n_anchors=4, k=8):
    n_nodes = 2 * n_seqs
    rows = {}
    for u in range(n_nodes):
        if rng.random() < 0.15:
            continue
        deg = int(rng.integers(1, k + 1))
        dsts = rng.choice(n_nodes, size=deg, replace=False)
        rows[u] = [
            (int(d), float(np.float32(rng.uniform(0.1, 50))),
             float(np.float32(rng.uniform(0.1, 50))), int(rng.integers(1, 500)))
            for d in dsts
        ]
    return mk_graph(n_nodes, n_anchors, k, rows)


@pytest.mark.parametrize("mode", [MODE_GREEDY_OS, MODE_GREEDY_ES, MODE_MC])
def test_engine_matches_oracle(rng, mode):
    g = random_graph(rng)
    cfg = ScaffoldConfig(mc_walks_per_end=3, max_steps=10)
    plan = plan_walks(g, cfg)
    sel = np.flatnonzero(plan.active & (plan.mode == mode))[:40]
    r = run(g, plan, seed=11, max_steps=10)
    choice = jax_choice_fn(11, 10)
    for i in sel:
        o = walk_oracle(g, int(plan.start[i]), int(plan.first_edge[i]), mode,
                        int(plan.uid[i]), 10, choice)
        n_real = o.steps + 1
        assert list(r.nodes[i][:n_real]) == o.nodes, f"walk {i}"
        assert r.steps[i] == o.steps
        assert bool(r.success[i]) == o.success
        assert r.terminal[i] == o.terminal
        assert r.path_len[i] == o.path_len
        # fixed step-order f32 sum on both sides: bit-identical
        assert np.float32(r.score_sum[i]) == np.float32(o.score_sum)


def test_plan_walks_enumeration():
    g = chain_graph()
    cfg = ScaffoldConfig(mc_walks_per_end=5, walk_batch_multiple=8)
    p = plan_walks(g, cfg)
    # anchor ends with deg>0: node 0 (deg 1) -> 2 greedy + 5 mc = 7 walks
    assert p.n_active == 7
    assert len(p) % 8 == 0
    # sectioned layout: greedy rows first, then mc; uids assigned before padding
    glo, ghi = p.sections["greedy"]
    mlo, mhi = p.sections["mc"]
    assert list(p.uid[glo:glo + 2]) == [0, 1]
    assert list(p.uid[mlo:mlo + 5]) == [2, 3, 4, 5, 6]
    # padding rows are inactive with uids past the active range
    assert not p.active[ghi - 1] and p.uid[ghi - 1] >= 7
    # uid_to_row inverts the layout
    lut = p.uid_to_row()
    for uid in range(7):
        assert p.uid[lut[uid]] == uid


def test_sectioned_equals_mixed():
    from telomeri_tpu.walk.engine import (
        graph_to_device, plan_to_device, run_walks_sectioned)

    g = chain_graph()
    cfg = ScaffoldConfig(mc_walks_per_end=6, max_steps=8)
    p = plan_walks(g, cfg)
    gd = graph_to_device(g)
    mixed = run_walks(gd, plan_to_device(p), 5, n_anchors=g.n_anchors,
                      max_steps=8).to_numpy()
    sect = run_walks_sectioned(gd, p, 5, n_anchors=g.n_anchors,
                               max_steps=8).to_numpy()
    for a, b in zip(mixed, sect):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fast_choice_fn_valid():
    fn = fast_choice_fn(0)
    # cumsum of weights [0, 2, 0, 1]: zero-weight slots are never picked
    cum = np.array([0, 2, 2, 3], np.int64)
    for s in range(20):
        c = fn(0, s, cum)
        assert c in (1, 3)
    # all-zero row: dead end
    assert fn(0, 0, np.array([0, 0, 0, 0], np.int64)) == -1


def test_greedy_only_plan_no_mc_section():
    g = chain_graph()
    cfg = ScaffoldConfig(mc_walks_per_end=0, walk_batch_multiple=8)
    p = plan_walks(g, cfg)
    lo, hi = p.sections["mc"]
    assert lo == hi  # empty MC section: no ghost scan
    from telomeri_tpu.walk.engine import graph_to_device, run_walks_sectioned
    r = run_walks_sectioned(graph_to_device(g), p, 0, n_anchors=g.n_anchors,
                            max_steps=8).to_numpy()
    assert r.success.any()


def test_no_anchor_ends_empty_result():
    # anchors exist but have zero out-degree
    g = mk_graph(6, 2, 2, {4: [(5, 1.0, 1.0, 10)]})
    cfg = ScaffoldConfig(mc_walks_per_end=4)
    p = plan_walks(g, cfg)
    from telomeri_tpu.walk.engine import graph_to_device, run_walks_sectioned
    r = run_walks_sectioned(graph_to_device(g), p, 0, n_anchors=g.n_anchors,
                            max_steps=8).to_numpy()
    assert len(r.steps) == 0


def test_oracle_fast_choice_dead_end_no_phantom_success():
    """fast_choice_fn on an all-zero-weight row must kill the walk, not pick
    slot 0 and 'succeed' onto a pad neighbour (terminal=-1)."""
    import numpy as np

    from telomeri_tpu.graph.tensorize import GraphTensors
    from telomeri_tpu.walk.oracle import fast_choice_fn, walk_oracle
    from telomeri_tpu.walk.plan import MODE_MC

    n, k = 8, 4
    nbr = np.full((n, k), -1, np.int32)
    es = np.zeros((n, k), np.float32)
    # node 2 (an anchor end) has ONE edge to node 6, whose row is empty
    nbr[2, 0], es[2, 0] = 6, 5.0
    g = GraphTensors(nbr=nbr, es=es, os_=es.copy(),
                     adv=np.ones((n, k), np.int32),
                     eid=np.where(nbr >= 0, 0, -1).astype(np.int32),
                     deg=(nbr >= 0).sum(1).astype(np.int32),
                     seq_len=np.full(n // 2, 10, np.int32), n_anchors=1)
    w = walk_oracle(g, 2, -1, MODE_MC, 0, 8, fast_choice_fn(0))
    assert not w.success and w.terminal == -1
    assert all(x >= 0 for x in w.nodes)


def test_mc_stream_stable_across_max_steps():
    """The MC draw stream is a stable PREFIX in max_steps (engine._stable_bits_table):
    raising the step budget appends draws without changing earlier ones, so a walk
    that terminates within the smaller budget makes IDENTICAL decisions under the
    larger one (round-2 fix for the cross-config reproducibility footgun)."""
    rng = np.random.default_rng(7)
    n, k, n_anchors = 40, 8, 3
    rows = {}
    for src in range(2 * n_anchors, n):
        dsts = rng.choice(n, size=rng.integers(1, k), replace=False)
        rows[src] = [(int(d), float(rng.uniform(1, 50)), 1.0, 10) for d in dsts]
    for a in range(2 * n_anchors):
        dsts = rng.choice(np.arange(2 * n_anchors, n), size=4, replace=False)
        rows[a] = [(int(d), float(rng.uniform(1, 50)), 1.0, 10) for d in dsts]
    g = mk_graph(n, n_anchors, k, rows)
    starts = [0, 1, 2, 3, 4, 5] * 8
    p = mk_plan(starts, [-1] * len(starts), [MODE_MC] * len(starts))
    r_small = run(g, p, seed=3, max_steps=9)   # odd budget: exercises the half block
    r_big = run(g, p, seed=3, max_steps=32)
    done_small = (r_small.success | (r_small.steps < 9))
    assert done_small.any(), "want walks that terminate within the small budget"
    idx = np.where(done_small)[0]
    np.testing.assert_array_equal(r_small.steps[idx], r_big.steps[idx])
    np.testing.assert_array_equal(r_small.success[idx], r_big.success[idx])
    np.testing.assert_array_equal(r_small.terminal[idx], r_big.terminal[idx])
    s = min(r_small.nodes.shape[1], r_big.nodes.shape[1])
    np.testing.assert_array_equal(r_small.nodes[idx, :s], r_big.nodes[idx, :s])


@pytest.mark.parametrize("max_batch", [8, 64, 1000])
def test_chunked_walks_bitwise_equal_single_dispatch(rng, max_batch):
    """run_walks_chunked (the genome-scale HBM bound, config.max_walk_batch):
    chunked output is BITWISE identical to one full dispatch at any chunk size
    — records are uid-keyed, so batch splitting cannot change any walk."""
    from telomeri_tpu.walk.engine import run_walks_chunked, run_walks_sectioned

    g = random_graph(rng)
    cfg = ScaffoldConfig(mc_walks_per_end=16, max_steps=10)
    p = plan_walks(g, cfg)
    gd = graph_to_device(g)
    one = run_walks_sectioned(gd, p, 7, n_anchors=g.n_anchors,
                              max_steps=10).to_numpy()
    chunked = run_walks_chunked(gd, p, 7, n_anchors=g.n_anchors, max_steps=10,
                                max_batch=max_batch)
    for f, a, b in zip(one._fields, one, chunked):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)


@pytest.mark.parametrize("max_batch", [7, 60])
def test_chunked_walks_one_compiled_shape_per_section(rng, max_batch, monkeypatch):
    """VERDICT r4 next-3: in a multi-chunk section every dispatch (tail
    included) must have the SAME batch shape — the exact-size tail slice
    compiled one extra program per section length at genome scale. Sections
    small enough for one dispatch keep their
    exact shape. Output must stay bitwise identical with a non-dividing tail."""
    import telomeri_tpu.walk.engine as E
    from telomeri_tpu.walk.engine import run_walks_chunked, run_walks_sectioned

    g = random_graph(rng)
    cfg = ScaffoldConfig(mc_walks_per_end=16, max_steps=10)
    p = plan_walks(g, cfg)
    assert any(hi - lo > max_batch and (hi - lo) % max_batch
               for _, (lo, hi) in p.sections.items()), \
        "fixture must exercise a non-dividing tail"
    gd = graph_to_device(g)
    shapes: list[int] = []
    real = E.plan_to_device

    def spy(sub, *a, **k):
        shapes.append(len(sub.start))
        return real(sub, *a, **k)

    monkeypatch.setattr(E, "plan_to_device", spy)
    chunked = run_walks_chunked(gd, p, 7, n_anchors=g.n_anchors, max_steps=10,
                                max_batch=max_batch)
    monkeypatch.undo()
    # every multi-chunk section dispatched only max_batch-sized chunks
    for kind, (lo, hi) in p.sections.items():
        if hi - lo > max_batch:
            n = -(-(hi - lo) // max_batch)
            assert shapes.count(max_batch) >= n
    assert set(shapes) <= {max_batch} | {
        hi - lo for _, (lo, hi) in p.sections.items() if hi - lo <= max_batch}
    one = run_walks_sectioned(gd, p, 7, n_anchors=g.n_anchors,
                              max_steps=10).to_numpy()
    for f, a, b in zip(one._fields, one, chunked):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)


def _resolve_oracle(start, active, nxts, totals, eids, adv, es, n_anchors, S):
    """Scalar numpy mirror of _resolve_mc_events' event semantics."""
    W = len(start)
    big = S + 1
    out = []
    for i in range(W):
        seq = [int(start[i])] + [int(x) for x in nxts[i]]
        t_rev = t_dead = t_anchor = big
        for t in range(S):
            if nxts[i, t] in seq[: t + 1] and t < t_rev:
                t_rev = t
                break
        for t in range(S):
            if totals[i, t] <= 0:
                t_dead = t
                break
        for t in range(S):
            if nxts[i, t] < 2 * n_anchors:
                t_anchor = t
                break
        t_kill = 0 if not active[i] else min(t_rev, t_dead)
        success = t_anchor < t_kill
        n_taken = t_anchor + 1 if success else min(t_kill, S)
        terminal = int(nxts[i, t_anchor]) if success else -1
        nodes = [int(start[i])] + [int(nxts[i, t]) if t < n_taken else -1
                                   for t in range(S)]
        row_eids = [int(eids[i, t]) if t < n_taken else -1 for t in range(S)]
        plen = int(sum(adv[i, t] for t in range(n_taken)))
        ssum = np.float32(sum(es[i, t] for t in range(n_taken)))
        out.append((nodes, row_eids, n_taken, success, terminal, plen, ssum))
    return out


def test_resolve_mc_events_pairwise_branch_parity(rng):
    """VERDICT r4 weak 4: the O(S^2) pairwise revisit path (graphs past
    ~33M oriented nodes, where node*mult overflows int32) was the only
    untested hot-path branch. Force it via a fake-large n_nodes on records
    whose node VALUES fit either path, and assert bit parity with the sort
    path AND a scalar oracle."""
    import jax.numpy as jnp

    from telomeri_tpu.walk.engine import PlanDev, _resolve_mc_events

    W, S, n_anchors, n_nodes = 96, 12, 8, 50_000
    nxts = rng.integers(2 * n_anchors, n_nodes, (W, S)).astype(np.int32)
    start = rng.integers(2 * n_anchors, n_nodes, W).astype(np.int32)
    # plant every event class
    for i in range(0, 16):
        nxts[i, 5] = start[i]                      # revisit the start
    for i in range(16, 32):
        nxts[i, 7] = nxts[i, 2]                    # revisit an interior node
    totals = rng.integers(1, 5, (W, S)).astype(np.int32)
    for i in range(32, 40):
        totals[i, 4] = 0                           # dead row
    for i in range(40, 56):
        nxts[i, 3] = int(rng.integers(0, 2 * n_anchors))   # anchor hit
    for i in range(56, 64):                        # anchor + kill same step
        nxts[i, 3] = int(rng.integers(0, 2 * n_anchors))
        totals[i, 3] = 0
    eids = rng.integers(0, 1000, (W, S)).astype(np.int32)
    adv = rng.integers(0, 500, (W, S)).astype(np.int32)
    # integral-valued floats: any float32 summation order is exact, so the
    # oracle's sequential sum matches the engine's vectorized reduce bitwise
    es = rng.integers(0, 100, (W, S)).astype(np.float32)
    active = np.ones(W, bool)
    active[90:] = False
    p = PlanDev(start=jnp.asarray(start), first_edge=jnp.full(W, -1, jnp.int32),
                mode=jnp.full(W, MODE_MC, jnp.int32),
                uid=jnp.arange(W, dtype=jnp.int32), active=jnp.asarray(active))
    args = (jnp.asarray(nxts), jnp.asarray(totals), jnp.asarray(eids),
            jnp.asarray(adv), jnp.asarray(es.view(np.int32)))
    srt = _resolve_mc_events(p, *args, n_nodes=n_nodes, n_anchors=n_anchors,
                             max_steps=S).to_numpy()
    # mult = 64 at S=12, so 40M nodes forces the pairwise branch (n_nodes is
    # only ever used for branch selection)
    pw = _resolve_mc_events(p, *args, n_nodes=40_000_000, n_anchors=n_anchors,
                            max_steps=S).to_numpy()
    for f, a, b in zip(srt._fields, srt, pw):
        np.testing.assert_array_equal(a, b, err_msg=f)
    oracle = _resolve_oracle(start, active, nxts, totals, eids, adv, es,
                             n_anchors, S)
    for i, (nodes, reids, n_taken, success, terminal, plen, ssum) in \
            enumerate(oracle):
        assert srt.nodes[i].tolist() == nodes, i
        assert srt.eids[i].tolist() == reids, i
        assert int(srt.steps[i]) == n_taken, i
        assert bool(srt.success[i]) == success, i
        assert int(srt.terminal[i]) == terminal, i
        assert int(srt.path_len[i]) == plen, i
        assert np.float32(srt.score_sum[i]) == ssum, i


def test_resolve_mc_events_large_node_id_smoke(rng):
    """>33M-oriented-node regime smoke (records only, tiny W): node ids past
    the int32 packing limit resolve correctly through the pairwise branch."""
    import jax.numpy as jnp

    from telomeri_tpu.walk.engine import PlanDev, _resolve_mc_events

    W, S, n_anchors, n_nodes = 8, 12, 8, 60_000_000
    nxts = rng.integers(40_000_000, n_nodes, (W, S)).astype(np.int32)
    start = rng.integers(40_000_000, n_nodes, W).astype(np.int32)
    nxts[0, 4] = start[0]                          # revisit
    nxts[1, 2] = 3                                 # anchor hit
    totals = rng.integers(1, 5, (W, S)).astype(np.int32)
    totals[2, 1] = 0                               # dead
    eids = rng.integers(0, 100, (W, S)).astype(np.int32)
    adv = rng.integers(0, 50, (W, S)).astype(np.int32)
    es = rng.integers(0, 100, (W, S)).astype(np.float32)
    p = PlanDev(start=jnp.asarray(start), first_edge=jnp.full(W, -1, jnp.int32),
                mode=jnp.full(W, MODE_MC, jnp.int32),
                uid=jnp.arange(W, dtype=jnp.int32),
                active=jnp.ones(W, bool))
    res = _resolve_mc_events(
        p, jnp.asarray(nxts), jnp.asarray(totals), jnp.asarray(eids),
        jnp.asarray(adv), jnp.asarray(es.view(np.int32)),
        n_nodes=n_nodes, n_anchors=n_anchors, max_steps=S).to_numpy()
    oracle = _resolve_oracle(start, np.ones(W, bool), nxts, totals, eids, adv,
                             es, n_anchors, S)
    for i, (nodes, reids, n_taken, success, terminal, plen, ssum) in \
            enumerate(oracle):
        assert res.nodes[i].tolist() == nodes, i
        assert int(res.steps[i]) == n_taken, i
        assert bool(res.success[i]) == success, i
        assert int(res.terminal[i]) == terminal, i


def test_pipeline_output_invariant_to_max_walk_batch(tmp_path, toy_dataset_dir):
    """End-to-end: a tiny max_walk_batch (forcing many chunks) writes the same
    FASTA bytes as the unchunked default."""
    import dataclasses

    from telomeri_tpu.pipeline import run_pipeline

    args = [f"{toy_dataset_dir}/{f}" for f in
            ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")]
    cfg = ScaffoldConfig(mc_walks_per_end=30, max_steps=16)
    run_pipeline(*args, str(tmp_path / "a.fa"), cfg)
    run_pipeline(*args, str(tmp_path / "b.fa"),
                 dataclasses.replace(cfg, max_walk_batch=64))
    assert open(tmp_path / "a.fa", "rb").read() == \
        open(tmp_path / "b.fa", "rb").read()
