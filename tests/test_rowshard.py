"""Row-sharded (>HBM) graph walks must equal the replicated engine byte-for-byte.

The row-sharded mode (dist/rowshard.py) is the SURVEY.md §6 "long-context analog"
fallback: CSR rows sharded over the mesh, per-step rows fetched with
all_gather + masked local gather + psum_scatter. Exactly one shard contributes a
nonzero row per walk, so the psum is exact and every field of WalkResult must be
identical to the single-device replicated run — on any mesh size, including one
that does not divide the node count (dead-row padding path).
"""

import numpy as np
import pytest

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.consensus.grouping import compress, group_and_select, summarize
from telomeri_tpu.dist.mesh import make_walk_mesh
from telomeri_tpu.dist.rowshard import run_walks_rowsharded, shard_graph_rows
from telomeri_tpu.walk.engine import run_walks_host
from telomeri_tpu.walk.plan import plan_walks

CFG = ScaffoldConfig(mc_walks_per_end=40, max_steps=16)


@pytest.fixture(scope="module")
def toy_graph(toy_sim, tmp_path_factory):
    from telomeri_tpu.pipeline import build_graph, load_inputs
    from telomeri_tpu.sim import write_dataset

    d = tmp_path_factory.mktemp("rowshard_toy")
    write_dataset(toy_sim, str(d))
    contigs, reads, paf = load_inputs(
        str(d / "contigs.fa"), str(d / "reads.fa"),
        str(d / "read2contig.paf"), str(d / "read2read.paf"))
    edges, graph = build_graph(contigs, reads, paf, CFG)
    return graph


@pytest.mark.parametrize("n_dev", [2, 8])
def test_rowsharded_equals_replicated(toy_graph, n_dev):
    g = toy_graph
    plan = plan_walks(g, CFG, n_shards=n_dev)
    ref = run_walks_host(g, plan, CFG)

    mesh = make_walk_mesh(n_dev)
    res = run_walks_rowsharded(
        g, plan, CFG.mc_seed, n_anchors=g.n_anchors,
        max_steps=CFG.max_steps, mesh=mesh).to_numpy()

    np.testing.assert_array_equal(ref.nodes, res.nodes)
    np.testing.assert_array_equal(ref.eids, res.eids)
    np.testing.assert_array_equal(ref.steps, res.steps)
    np.testing.assert_array_equal(ref.success, res.success)
    np.testing.assert_array_equal(ref.terminal, res.terminal)
    np.testing.assert_array_equal(ref.path_len, res.path_len)
    np.testing.assert_array_equal(
        np.asarray(ref.score_sum), np.asarray(res.score_sum))


def test_rowsharded_consensus_equals_replicated(toy_graph):
    g = toy_graph
    plan = plan_walks(g, CFG, n_shards=8)
    ref = run_walks_host(g, plan, CFG)
    ref_cons = compress(group_and_select(
        summarize(ref, plan.uid), n_anchors=g.n_anchors,
        group_window=CFG.group_window, min_support=CFG.min_group_support))

    mesh = make_walk_mesh(8)
    res = run_walks_rowsharded(
        g, plan, CFG.mc_seed, n_anchors=g.n_anchors,
        max_steps=CFG.max_steps, mesh=mesh).to_numpy()
    cons = compress(group_and_select(
        summarize(res, plan.uid), n_anchors=g.n_anchors,
        group_window=CFG.group_window, min_support=CFG.min_group_support))
    assert cons == ref_cons


def test_row_padding_dead_rows(toy_graph):
    """Node count rarely divides the mesh size: the pad rows must be inert."""
    mesh = make_walk_mesh(8)
    gdev = shard_graph_rows(toy_graph, mesh)
    n = toy_graph.nbr.shape[0]
    assert gdev.wide.shape[0] % 8 == 0
    assert gdev.wide.shape[0] >= n
    pad = np.asarray(gdev.wide)[n:]
    if pad.size:
        h = gdev.h
        assert (pad[:, :h] == -1).all()          # nbr slots dead
        assert (pad[:, h:2 * h] == 0).all()      # zero CDF => total 0 => dead row


def test_pipeline_rowshard_output_identical(toy_dataset_dir, tmp_path):
    import os

    from telomeri_tpu.pipeline import run_pipeline

    args = [os.path.join(toy_dataset_dir, f) for f in
            ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")]
    out1 = str(tmp_path / "single.fa")
    outr = str(tmp_path / "rowshard8.fa")
    run_pipeline(*args, out1, CFG)
    import dataclasses

    cfg_rs = dataclasses.replace(CFG, graph_placement="rowshard")
    run_pipeline(*args, outr, cfg_rs, mesh=make_walk_mesh(8))
    assert open(out1, "rb").read() == open(outr, "rb").read(), \
        "row-sharded output must be byte-identical to replicated single-device"


def test_rowshard_requires_mesh(toy_dataset_dir, tmp_path):
    import dataclasses
    import os

    from telomeri_tpu.pipeline import run_pipeline

    args = [os.path.join(toy_dataset_dir, f) for f in
            ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")]
    cfg_rs = dataclasses.replace(CFG, graph_placement="rowshard")
    with pytest.raises(ValueError, match="rowshard"):
        run_pipeline(*args, str(tmp_path / "x.fa"), cfg_rs)


def test_plan_not_divisible_raises(toy_graph):
    """The error path must ALWAYS be exercised: force a section whose length is
    not divisible by the mesh size (plan_walks(n_shards=3) only usually produces
    one — advisor r2 flagged the conditional as silently passable)."""
    import dataclasses

    mesh = make_walk_mesh(8)
    plan = plan_walks(toy_graph, CFG, n_shards=3)
    sections_divisible = plan.sections is not None and all(
        (hi - lo) % 8 == 0 for lo, hi in plan.sections.values())
    if sections_divisible:
        # shrink the mc section by one row: guaranteed non-divisible by 8
        lo, hi = plan.sections["mc"]
        assert hi - lo >= 2
        plan = dataclasses.replace(
            plan, sections={**plan.sections, "mc": (lo, hi - 1)})
    with pytest.raises(ValueError):
        run_walks_rowsharded(
            toy_graph, plan, CFG.mc_seed, n_anchors=toy_graph.n_anchors,
            max_steps=CFG.max_steps, mesh=mesh)


def test_auto_placement_resolution(toy_graph, monkeypatch):
    """graph_placement='auto': replicated for small graphs; rowshard only when
    the packed tables exceed the device budget AND a multi-device mesh exists."""
    import dataclasses

    from telomeri_tpu import pipeline as pl
    from telomeri_tpu.utils.logging import Metrics
    from telomeri_tpu.walk import engine

    cfg = dataclasses.replace(CFG, graph_placement="auto")
    mesh = make_walk_mesh(8)

    m = Metrics()
    out = pl._resolve_placement(cfg, toy_graph, mesh, m)
    assert out.graph_placement == "replicated"

    # a "graph" that claims not to fit one device must flip to rowshard
    monkeypatch.setattr(engine, "device_table_bytes", lambda g: 10**18)
    monkeypatch.setattr(pl, "_device_memory_limit", lambda dev: 80 * 2**30)
    m = Metrics()
    out = pl._resolve_placement(cfg, toy_graph, mesh, m)
    assert out.graph_placement == "rowshard"

    # ... but not without a multi-device mesh
    out = pl._resolve_placement(cfg, toy_graph, make_walk_mesh(1), Metrics())
    assert out.graph_placement == "replicated"
    out = pl._resolve_placement(cfg, toy_graph, None, Metrics())
    assert out.graph_placement == "replicated"

    # explicit placements pass through untouched
    for v in ("replicated", "rowshard"):
        explicit = dataclasses.replace(CFG, graph_placement=v)
        assert pl._resolve_placement(explicit, toy_graph, mesh,
                                     Metrics()).graph_placement == v


def test_auto_placement_unknown_limit_stays_replicated_on_cpu(toy_graph,
                                                              monkeypatch):
    """The CPU backend reports no memory limit: 'auto' keeps the graph
    replicated however large it claims to be, and says so; an accelerator
    without a reported limit is an error rather than a guessed size."""
    import dataclasses

    from telomeri_tpu import pipeline as pl
    from telomeri_tpu.utils.logging import Metrics
    from telomeri_tpu.walk import engine

    cfg = dataclasses.replace(CFG, graph_placement="auto")
    mesh = make_walk_mesh(8)
    assert pl._device_memory_limit(mesh.devices.flat[0]) is None
    monkeypatch.setattr(engine, "device_table_bytes", lambda g: 10**18)
    m = Metrics()
    out = pl._resolve_placement(cfg, toy_graph, mesh, m)
    assert out.graph_placement == "replicated"
    assert m.values["graph_placement"] == "replicated"

    class _Gpu:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            return None

    class _GpuMesh:
        size = 4
        devices = np.array([_Gpu()] * 4)

    with pytest.raises(RuntimeError, match="reports no memory limit"):
        pl._resolve_placement(cfg, toy_graph, _GpuMesh(), Metrics())
