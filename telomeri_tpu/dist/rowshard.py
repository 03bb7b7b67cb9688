"""Row-sharded graph walks: the >HBM fallback (SURVEY.md §6 "long-context analog").

The replicated-graph design ([BASELINE]; dist/mesh.py) caps graph size at ONE card's
device memory. Graphs beyond that — higher coverage, larger genomes, wider K — shard
their CSR ROWS over the same 1-D mesh the walks use: device i holds rows
[i*N/D, (i+1)*N/D) of the packed wide table, so the aggregate capacity scales with
the mesh (D x device memory) instead of replicating.

Each walk step then needs rows owned by OTHER devices. The fetch is three XLA
collectives, which XLA hands to NCCL over NVLink (every card of a host reaches every
other at the same rate, so the 1-D mesh needs no topology shape; no hand-written
transport — SURVEY.md §6 "Comm backend"):

    cur_all = all_gather(cur_local)                      # (W,) int32 — tiny
    part    = where(owned, wide_local[cur_all - off], 0) # masked local gather
    rows    = psum_scatter(part, scatter_dim=0)          # (W/D, 6H) back to owner

Exactly one shard contributes a nonzero row per walk (ids are unique), so the psum
is EXACT for both the int32 wide blocks and the f32 OS rows (x + 0 == x): results
are byte-identical to the replicated engine (tests/test_rowshard.py). Per step the
collective moves ~W*6H*4 B between the cards, so the memory headroom costs step
latency, paid only on graphs that could not run replicated at all.

The walk scan itself is unchanged: the engine cores (walk/engine.py _mc_fast_core /
_kind_core) take the row fetch as a parameter; this module supplies the collective
one inside shard_map. Reference parity: the C++ reference is single-process with
the whole graph in RAM (SURVEY.md §2.1); this subsystem is introduced by this
framework, decomposition per SURVEY.md §3 "Distributed components".
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from telomeri_tpu.dist.mesh import WALK_AXIS, walk_sharded
from telomeri_tpu.graph.tensorize import GraphTensors
from telomeri_tpu.walk.engine import (
    GraphDev,
    PlanDev,
    WalkResult,
    _cum_arrays,
    _kind_core,
    _mc_fast_core,
    _pad_cols,
    lane_width,
    pack_wide,
    prepare_plan_sections,
)
from telomeri_tpu.walk.plan import WalkPlan


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Shard dim 0 (graph rows) over the walk axis; replicate columns."""
    return NamedSharding(mesh, P(WALK_AXIS, None))


def shard_graph_rows(g: GraphTensors, mesh: Mesh) -> GraphDev:
    """Pack the CSR into the wide device layout with rows SHARDED over the mesh.

    Rows are padded to a multiple of mesh.size with dead rows (nbr/eid = -1,
    cum = 0 so the row total is 0); no real node id ever points at them.
    """
    h = lane_width(g.nbr.shape[1])
    wide = pack_wide(g.nbr, _cum_arrays(g), g.eid, g.adv, g.es, g.os_, h)
    n = wide.shape[0]
    n_pad = -n % mesh.size
    if n_pad:
        pad = np.zeros((n_pad, wide.shape[1]), np.int32)
        pad[:, :h] = -1          # nbr
        pad[:, 2 * h:3 * h] = -1  # eid
        wide = np.concatenate([wide, pad], axis=0)
    return GraphDev(wide=jax.device_put(wide, row_sharded(mesh)))


def _collective_fetch(table: jax.Array):
    """fetch(cur_local) -> this shard's walks' rows, gathered across all shards."""
    rows_per = table.shape[0]
    off = (jax.lax.axis_index(WALK_AXIS) * rows_per).astype(jnp.int32)

    def fetch(cur: jax.Array) -> jax.Array:
        cur_all = jax.lax.all_gather(cur, WALK_AXIS, tiled=True)   # (W,)
        loc = cur_all - off
        owned = (loc >= 0) & (loc < rows_per)
        part = jnp.where(owned[:, None],
                         table[jnp.clip(loc, 0, rows_per - 1)],
                         jnp.zeros((), table.dtype))
        return jax.lax.psum_scatter(part, WALK_AXIS, scatter_dimension=0,
                                    tiled=True)                    # (W/D, cols)

    return fetch


@functools.partial(jax.jit,
                   static_argnames=("max_steps", "kinds", "n_nodes", "mesh"))
def _run_multi_rowsharded(
    g: GraphDev, pds: tuple, seed, *, n_anchors, max_steps: int, kinds: tuple,
    n_nodes: int, mesh: Mesh,
) -> WalkResult:
    h = g.wide.shape[1] // 6

    # shard_map over everything: graph rows P(axis, None), plan/results P(axis);
    # the scalar seed/n_anchors ride replicated. Plan sections are flattened into
    # positional operands (shard_map takes explicit operands, not closures).
    # Sections come back SEPARATELY (a tuple per section) and are concatenated
    # OUTSIDE the shard_map: concatenating the local sections inside the body
    # would interleave the global order by device ([g0,m0,g1,m1,...]) instead of
    # the replicated engine's [greedy..., mc...] contract (pipeline.py emit order).
    def body(wide, seed_, na, *flat_plans):
        def one(pd_arrays, kind):
            pd = PlanDev(*pd_arrays)
            if kind == "mc":
                return tuple(_mc_fast_core(
                    _collective_fetch(wide), n_nodes, h, pd, seed_,
                    n_anchors=na, max_steps=max_steps))
            # OS rides in the wide row's [5H:6H) block: ONE collective fetch
            # per step for greedy too (advisor r2: the separate OS fetch
            # doubled the all_gather + psum_scatter count)
            return tuple(_kind_core(
                _collective_fetch(wide), h, pd, seed_,
                n_anchors=na, max_steps=max_steps, kind=kind))

        return tuple(one(flat_plans[i * 5:(i + 1) * 5], kind)
                     for i, kind in enumerate(kinds))

    flat = [a for pd in pds for a in pd]
    in_specs = (P(WALK_AXIS, None), P(), P()) + \
        tuple(P(WALK_AXIS) for _ in flat)
    n_fields = len(WalkResult._fields)
    # check_vma off: the engine cores init scan carries from replicated zeros
    # that BECOME device-varying after step 1 (they mix in fetched rows); the
    # static varying-axis checker cannot express that and the cores cannot
    # pcast without knowing the axis. Correctness is covered by the byte-parity
    # tests against the replicated engine (tests/test_rowshard.py).
    outs = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                         check_vma=False,
                         out_specs=tuple(
                             tuple(P(WALK_AXIS) for _ in range(n_fields))
                             for _ in kinds))(
        g.wide, jnp.asarray(seed, jnp.int32),
        jnp.asarray(n_anchors, jnp.int32), *flat)
    if len(outs) == 1:
        return WalkResult(*outs[0])
    return WalkResult(*(jnp.concatenate(a, axis=0) for a in zip(*outs)))


def run_walks_rowsharded(
    g: GraphTensors | GraphDev, plan: WalkPlan, seed, *,
    n_anchors: int, max_steps: int, mesh: Mesh, n_nodes: int | None = None,
) -> WalkResult:
    """Sectioned walks over a ROW-SHARDED graph; byte-identical to the replicated
    run_walks_sectioned on the same plan (tests/test_rowshard.py).

    Walk batches stay data-parallel over the same mesh axis (plan sections must
    divide mesh.size — plan_walks(n_shards=mesh.size)); results come back
    walk-sharded, ready for dist.mesh's gathered consensus."""
    if isinstance(g, GraphTensors):
        n_nodes = g.nbr.shape[0]
        n_anchors = g.n_anchors
        g = shard_graph_rows(g, mesh)
    elif n_nodes is None:
        raise ValueError("n_nodes (GLOBAL row count) required with a GraphDev")
    if plan.sections is not None:
        for kind, (lo, hi) in plan.sections.items():
            if (hi - lo) % mesh.size != 0:
                raise ValueError(
                    f"plan section {kind!r} ({hi - lo} walks) not divisible by "
                    f"mesh size {mesh.size}; re-run plan_walks(n_shards="
                    f"{mesh.size})")
    elif len(plan) % mesh.size != 0:
        raise ValueError(
            f"walk batch {len(plan)} not divisible by mesh size {mesh.size}")
    sections = prepare_plan_sections(plan, walk_sharded(mesh))
    if not sections:
        z = lambda *shape: jnp.zeros(shape, jnp.int32)
        return WalkResult(nodes=z(0, max_steps + 1), eids=z(0, max_steps),
                          steps=z(0), success=jnp.zeros(0, bool), terminal=z(0),
                          path_len=z(0), score_sum=jnp.zeros(0, jnp.float32))
    return _run_multi_rowsharded(
        g, tuple(pd for _, pd in sections), seed, n_anchors=n_anchors,
        max_steps=max_steps, kinds=tuple(kind for kind, _ in sections),
        n_nodes=n_nodes, mesh=mesh)
