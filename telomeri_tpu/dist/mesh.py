"""Device mesh + data-parallel walk sharding (SURVEY.md §3 distributed components).

The reference is a single-process tool; the distributed design is introduced here, with
the decomposition fixed by the north star (SURVEY.md §1): the overlap graph is
REPLICATED on every chip (read-only during walks), walk batches are SHARDED
data-parallel over a 1-D "walks" mesh axis, candidate-path summaries are merged by
all-gather, and the consensus segment reductions then run replicated — identical on
every device/host, so the scaffold decision is host-count-invariant (SURVEY.md §5
item 6, §7 "cross-host determinism": walk uids, not device ids, seed the RNG streams
and break ties).

Mechanism: jax.sharding.NamedSharding annotations + jit — XLA GSPMD inserts the actual
collectives (all-gather on the replication constraint), which XLA hands to NCCL over
NVLink between the cards of a host; no hand-written transport (SURVEY.md §6 "Comm
backend"). Multi-host entry:
`jax.distributed.initialize()` before building the mesh (init_distributed()).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.consensus.grouping import ConsensusResult, group_and_select, summarize
from telomeri_tpu.graph.tensorize import GraphTensors
from telomeri_tpu.walk.engine import (
    GraphDev,
    PlanDev,
    WalkResult,
    graph_to_device,
    plan_to_device,
    run_walks_sectioned,
)
from telomeri_tpu.walk.plan import WalkPlan

WALK_AXIS = "walks"


def init_distributed(**kwargs) -> None:
    """Multi-host process init.

    With kwargs (coordinator_address/num_processes/process_id) initializes exactly as
    asked. Without kwargs, JAX auto-detects a cluster environment (SLURM, Open MPI,
    Kubernetes, JAX_COORDINATOR_ADDRESS); on a single host with none of them it
    raises ValueError at once, without waiting for a coordinator, and the run stays
    single-process. NOTE: do not probe jax.process_count() first — it initializes
    the local backend and always reports 1 before jax.distributed.initialize()
    has run."""
    from telomeri_tpu.utils.logging import log

    try:
        jax.distributed.initialize(**kwargs)
    except ValueError as e:  # no cluster environment detected
        if kwargs:
            raise
        log.info("jax.distributed not initialized (%s); single-process mode", e)


def make_walk_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the walk batch dimension."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (WALK_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def walk_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(WALK_AXIS))


def shard_graph(g: GraphTensors, mesh: Mesh) -> GraphDev:
    return graph_to_device(g, replicated(mesh))


def shard_plan(p: WalkPlan, mesh: Mesh) -> PlanDev:
    if len(p) % mesh.size != 0:
        raise ValueError(f"walk batch {len(p)} not divisible by mesh size {mesh.size}")
    return plan_to_device(p, walk_sharded(mesh))


def run_walks_distributed(
    g: GraphTensors | GraphDev,
    plan: WalkPlan | PlanDev,
    cfg: ScaffoldConfig,
    mesh: Mesh,
    n_anchors: int | None = None,
    virtual_base: int | None = None,
) -> tuple[WalkResult, ConsensusResult]:
    """Sharded walks + gathered consensus: the distributed score+walk+merge step.

    Returns (walk records [still walk-sharded], consensus [replicated]).
    cfg.graph_placement == "rowshard" swaps the replicated graph for CSR rows
    sharded over the same mesh (>HBM graphs; dist/rowshard.py) — byte-identical
    results, walk steps fetch rows via collectives.
    """
    if not isinstance(plan, WalkPlan):
        raise TypeError("run_walks_distributed expects a host WalkPlan")
    if cfg.graph_placement == "rowshard":
        from telomeri_tpu.dist.rowshard import run_walks_rowsharded

        if not isinstance(g, GraphTensors):
            raise TypeError("rowshard placement needs host GraphTensors "
                            "(rows are sharded at upload)")
        n_anchors, virtual_base = g.n_anchors, g.virtual_base
        res = run_walks_rowsharded(
            g, plan, cfg.mc_seed, n_anchors=n_anchors,
            max_steps=cfg.max_steps, mesh=mesh)
    else:
        if isinstance(g, GraphTensors):
            n_anchors, virtual_base = g.n_anchors, g.virtual_base
            g = shard_graph(g, mesh)
        if n_anchors is None:
            raise ValueError("n_anchors required when passing a GraphDev")
        if cfg.support_mode == "read_diverse" and virtual_base is None:
            raise ValueError("support_mode='read_diverse' needs virtual_base "
                             "when passing a GraphDev")
        if len(plan) % mesh.size != 0:
            raise ValueError(
                f"walk batch {len(plan)} not divisible by mesh size {mesh.size}")
        if plan.sections is not None:
            # the sectioned fast path shards each section independently — each must
            # divide the mesh (plan_walks pads to n_shards; rebuild the plan if the
            # mesh size changed after planning)
            for kind, (lo, hi) in plan.sections.items():
                if (hi - lo) % mesh.size != 0:
                    raise ValueError(
                        f"plan section {kind!r} ({hi - lo} walks) not divisible by "
                        f"mesh size {mesh.size}; re-run plan_walks(n_shards="
                        f"{mesh.size})")

        res = run_walks_sectioned(
            g, plan, cfg.mc_seed, n_anchors=n_anchors, max_steps=cfg.max_steps,
            sharding=walk_sharded(mesh))

    # all-gather the per-walk summaries (the "candidate path merge" collective), then
    # run the segment-reduce consensus replicated on every device.
    uid_dev = jax.device_put(plan.uid, walk_sharded(mesh))
    summary = summarize(res, uid_dev, virtual_base=virtual_base)
    summary = jax.device_put(summary, replicated(mesh))
    cons = group_and_select(
        summary, n_anchors=n_anchors, group_window=cfg.group_window,
        min_support=cfg.min_group_support, grouping=cfg.grouping,
        support=cfg.support_mode)
    return res, cons


def fetch_walk_rows(res: WalkResult, rows: np.ndarray, mesh: Mesh) -> WalkResult:
    """Gather specific walk-record rows out of a walk-sharded WalkResult into
    replicated host numpy (every process gets them).

    In a multi-process run the sharded records are NOT host-addressable, so the
    stitcher cannot np.asarray() them; only the representative walks are needed, so
    gather exactly those rows on device (XLA emits the cross-host collective) and
    replicate the tiny result."""
    idx = jax.device_put(np.asarray(rows, np.int32), replicated(mesh))
    take = jax.jit(
        lambda r, i: jax.tree.map(lambda a: a[i], r),
        out_shardings=jax.tree.map(lambda _: replicated(mesh), res),
    )
    return WalkResult(*[np.asarray(a) for a in take(res, idx)])
