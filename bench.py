"""Benchmark: Monte-Carlo walks/s on one GPU (primary) + overlaps scored/s.

Run: python bench.py   (one process; needs a GPU and exits non-zero without one)

Prints JSON lines on stdout, each tagged with the JAX device (platform,
device_kind, count) and the card's nvidia-smi name and power limit:

  {"metric": "mc_walks_per_s_per_chip", "value", "unit", "vs_baseline", ...}
      once per batch size: BENCH_MC_WALKS MC walks per anchor end (default
      4096 -> ~49.6k walks) and BENCH_PEAK_MC_WALKS (default 131072 -> ~1.57M
      walks; 0 skips it). vs_baseline is the device walks/s over the walks/s
      of the single-core scalar oracle (walk/oracle.py, the same per-step
      work), measured in this run on the same graph and plan.
  {"metric": "overlaps_scored_per_s", ...}
      the device rescore path (kernels/scoring.py score_os_es2_jnp) at 64M
      rows, with GB/s and the share of the card's published memory bandwidth.

Timed region (SURVEY.md §4.3): run_walks on a device-resident graph + plan after
one warm-up call (compile, reported as compile_s); each call ends in
block_until_ready; the value is the median over BENCH_REPEATS calls (default 10).
Host ingest is excluded. Progress goes to stderr.

BENCH_SCALE=hg002-graph instead times a 49,152-walk MC batch on the synthetic
whole-human-scale table (hg002_scale_graph). BENCH_SCALING=1 adds a walks/s sweep
over 1, 2, 4, ... devices of a multi-card host.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np


# Published device-memory bandwidth by JAX device_kind (NVIDIA's data sheet,
# H100 SXM). A device missing here is an error, not a default.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_label() -> dict:
    """The device fields every printed line carries; raises without a GPU."""
    from telomeri_tpu.utils.device import gpu_cards, require_gpu

    return {"device": require_gpu(), "card": gpu_cards()[0]}


def emit(label: dict, **fields):
    print(json.dumps({**fields, **label}), flush=True)


def median_call_s(fn, repeats: int) -> float:
    """Median wall time of fn() over `repeats` calls, each ended by
    block_until_ready (fn must already be compiled)."""
    import jax

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def build_problem(mc_walks_per_end: int, device_scoring: str = "auto"):
    from telomeri_tpu.config import ScaffoldConfig
    from telomeri_tpu.pipeline import build_graph, load_inputs
    from telomeri_tpu.sim import SimConfig, simulate, write_dataset
    from telomeri_tpu.walk.plan import plan_walks

    cfg = ScaffoldConfig(mc_walks_per_end=mc_walks_per_end, max_steps=32,
                         device_scoring=device_scoring)
    t0 = time.perf_counter()
    sim = simulate(SimConfig(
        genome_len=400_000, repeat_len=5_000, n_repeat_copies=6,
        read_len_mean=3_000, read_len_sd=500, coverage=20.0,
        error_rate=0.02, seed=12))
    with tempfile.TemporaryDirectory() as d:
        write_dataset(sim, d)
        contigs, reads, paf = load_inputs(
            os.path.join(d, "contigs.fa"), os.path.join(d, "reads.fa"),
            os.path.join(d, "read2contig.paf"), os.path.join(d, "read2read.paf"))
    edges, graph = build_graph(contigs, reads, paf, cfg)
    plan = plan_walks(graph, cfg)
    log(f"problem built in {time.perf_counter()-t0:.1f}s: {graph.stats}, "
        f"{plan.n_active} walks")
    return cfg, edges, graph, plan


def bench_walks(cfg, graph, plan, repeats: int):
    """(walks/s, walk-steps/s, compile+first-call s) of one plan."""
    import jax.numpy as jnp

    from telomeri_tpu.walk.engine import (
        graph_to_device, prepare_plan_sections, run_walks_prepared)

    gd = graph_to_device(graph)
    sections = prepare_plan_sections(plan)   # plan upload once, not per call
    run = lambda seed=cfg.mc_seed: run_walks_prepared(
        gd, sections, seed, n_anchors=graph.n_anchors, max_steps=cfg.max_steps)
    t0 = time.perf_counter()
    res = run()
    n_succ = int(np.asarray(res.success).sum())
    compile_s = time.perf_counter() - t0
    total_steps = int(np.asarray(jnp.sum(res.steps)))
    dt = median_call_s(run, repeats)
    log(f"walks: compile+first call {compile_s:.1f}s; {n_succ}/{plan.n_active} "
        f"successful; median {dt*1e3:.3f} ms/call over {repeats}")
    return plan.n_active / dt, total_steps / dt, compile_s


def bench_oracle(cfg, graph, plan, budget_s: float = 18.0, max_walks: int = 600):
    """Single-core scalar baseline on the SAME graph and walk plan.

    MONTE-CARLO rows only — the device metric is dominated by the MC section
    (~97% of a production plan) and greedy oracle walks do different per-step
    work. Evenly-spaced MC rows, median over 3 passes."""
    from telomeri_tpu.walk.oracle import fast_choice_fn, walk_oracle
    from telomeri_tpu.walk.plan import MODE_MC

    idx = np.flatnonzero(plan.active & (plan.mode == MODE_MC))
    sel = idx[np.linspace(0, len(idx) - 1, min(max_walks, len(idx))).astype(int)]
    rates = []
    for _ in range(3):
        choice = fast_choice_fn(cfg.mc_seed)  # fresh RNG: identical workload per pass
        t0 = time.perf_counter()
        n = 0
        for i in sel:
            walk_oracle(graph, int(plan.start[i]), int(plan.first_edge[i]),
                        int(plan.mode[i]), int(plan.uid[i]), cfg.max_steps,
                        choice)
            n += 1
            if time.perf_counter() - t0 > budget_s / 3:
                break
        rates.append(n / (time.perf_counter() - t0))
    walks_per_s = float(np.median(rates))
    log(f"oracle baseline: median {walks_per_s:,.1f} MC walks/s over 3 passes "
        f"(single core; passes {[f'{r:,.0f}' for r in rates]})")
    return walks_per_s


def scoring_inputs(n_rows: int, seed: int = 0) -> tuple:
    """n_rows of random int32 overlap geometry in kernels/scoring.py argument
    order (the value ranges of tests/test_scoring.py random_geom)."""
    rng = np.random.default_rng(seed)
    hi = (5000, 6000, 6000, 6000, 2000, 2000, 30000, 30000)
    lo = (1, 1, 0, 0, 0, 0, -1000, -1000)
    return tuple(rng.integers(a, b, n_rows, dtype=np.int32) for a, b in zip(lo, hi))


def bench_scoring(repeats: int, n_rows: int = 64 * 2**20) -> float:
    """The device rescore path (score_os_es2_jnp: 8 int32 in, 2 f32 out =
    40 B/row) at 64M rows, device-resident inputs. Returns s per call."""
    import jax

    from telomeri_tpu.kernels.scoring import score_os_es2_jnp

    args = tuple(jax.device_put(a) for a in scoring_inputs(n_rows))
    run = lambda: score_os_es2_jnp(*args)
    jax.block_until_ready(run())
    dt = median_call_s(run, repeats)
    log(f"scoring (jnp, 2-out): {n_rows:,} rows in {dt*1e3:.3f} ms -> "
        f"{n_rows * 40 / dt / 1e9:.0f} GB/s")
    return dt


def bench_scaling(cfg, graph, repeats: int, label: dict):
    """walks/s over 1, 2, 4, ... devices (replicated graph, sharded walks)."""
    import jax
    import jax.numpy as jnp

    from telomeri_tpu.dist.mesh import make_walk_mesh, run_walks_distributed
    from telomeri_tpu.walk.plan import plan_walks

    n_dev = len(jax.devices())
    for n in [d for d in (1, 2, 4, 8) if d <= n_dev]:
        mesh = make_walk_mesh(n)
        plan = plan_walks(graph, cfg, n_shards=n)
        run = lambda: run_walks_distributed(graph, plan, cfg, mesh)[0].steps
        _ = int(np.asarray(jnp.sum(run())))
        dt = median_call_s(run, repeats)
        emit(label, metric="mc_walks_per_s_scaling", value=plan.n_active / dt,
             unit="walks/s", mesh_devices=n, batch_walks=plan.n_active)


def hg002_scale_graph(n: int = 6_291_456, k: int = 64, n_anchors: int = 2000,
                      seed: int = 0):
    """Synthetic whole-human-scale walk table: n oriented nodes (the
    docs/ARCHITECTURE.md HG002 budget), K=k out-edge slots, random degrees in
    [4, k] and uniformly random destinations — no anchor locality, a worst
    case for gather locality. Returns GraphTensors with cumw filled."""
    from telomeri_tpu.graph.tensorize import GraphTensors
    from telomeri_tpu.walk.engine import _cum_arrays

    rng = np.random.default_rng(seed)
    deg = rng.integers(4, k + 1, n).astype(np.int32)
    mask = np.arange(k, dtype=np.int32)[None, :] < deg[:, None]
    es = np.where(mask, rng.uniform(100, 5000, (n, k)), 0).astype(np.float32)
    g = GraphTensors(
        nbr=np.where(mask, rng.integers(2 * n_anchors, n, (n, k)).astype(np.int32), -1),
        es=es, os_=es.copy(),
        adv=np.where(mask, rng.integers(100, 3000, (n, k)).astype(np.int32), 0),
        eid=np.where(mask, np.arange(n * k, dtype=np.int32).reshape(n, k), -1),
        deg=deg, seq_len=np.full(n // 2, 20000, np.int32), n_anchors=n_anchors)
    g.cumw = _cum_arrays(g)
    return g


def hg002_scale_plan(n_walks: int, n_anchors: int, seed: int = 0):
    """n_walks MC walks starting at random anchor ends."""
    from telomeri_tpu.walk.plan import MODE_MC, WalkPlan

    rng = np.random.default_rng(seed)
    return WalkPlan(
        start=rng.integers(0, 2 * n_anchors, n_walks).astype(np.int32),
        first_edge=np.full(n_walks, -1, np.int32),
        mode=np.full(n_walks, MODE_MC, np.int32),
        uid=np.arange(n_walks, dtype=np.int32), active=np.ones(n_walks, bool))


def bench_hg002_graph(repeats: int, label: dict):
    """49,152 MC walks (kind="mc", the sectioned fast path production plans
    take) on the whole-human-scale table."""
    import jax

    from telomeri_tpu.walk.engine import _run_walks_kind, graph_to_device, plan_to_device

    t0 = time.perf_counter()
    g = hg002_scale_graph()
    log(f"hg002 graph built on host in {time.perf_counter()-t0:.0f}s")
    gd = graph_to_device(g)
    gib = gd.wide.size * gd.wide.dtype.itemsize / 2**30
    pd = plan_to_device(hg002_scale_plan(49152, g.n_anchors))
    run = lambda: _run_walks_kind(gd, pd, 1, n_anchors=g.n_anchors, max_steps=32,
                                  kind="mc")
    jax.block_until_ready(run())
    dt = median_call_s(run, repeats)
    emit(label, metric="hg002_scale_walks_per_s_per_chip", value=49152 / dt,
         unit="walks/s", table_gib=gib)


def main() -> int:
    from telomeri_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    label = device_label()
    log(f"device {label}; compile cache {cache}")
    repeats = int(os.environ.get("BENCH_REPEATS", "10"))
    if os.environ.get("BENCH_SCALE") == "hg002-graph":
        bench_hg002_graph(repeats, label)
        return 0

    import dataclasses

    from telomeri_tpu.walk.plan import plan_walks

    mc_small = int(os.environ.get("BENCH_MC_WALKS", "4096"))
    mc_peak = int(os.environ.get("BENCH_PEAK_MC_WALKS", "131072"))
    cfg, _edges, graph, plan = build_problem(mc_small)
    oracle_per_s = bench_oracle(cfg, graph, plan)
    for mc in [mc_small] + ([mc_peak] if mc_peak > mc_small else []):
        cfg_mc = dataclasses.replace(cfg, mc_walks_per_end=mc)
        plan_mc = plan if mc == mc_small else plan_walks(graph, cfg_mc)
        walks_per_s, steps_per_s, compile_s = bench_walks(
            cfg_mc, graph, plan_mc, repeats)
        emit(label, metric="mc_walks_per_s_per_chip", value=walks_per_s,
             unit="walks/s", vs_baseline=walks_per_s / oracle_per_s,
             oracle_walks_per_s=oracle_per_s, device_steps_per_s=steps_per_s,
             batch_walks=plan_mc.n_active, compile_s=compile_s)
    n_rows = 64 * 2**20
    dt = bench_scoring(repeats, n_rows)
    emit(label, metric="overlaps_scored_per_s", value=n_rows / dt,
         unit="overlaps/s", gb_per_s=n_rows * 40 / dt / 1e9,
         hbm_roofline_share=n_rows * 40 / dt / HBM_BYTES_PER_S[label["device"]["kind"]])
    if os.environ.get("BENCH_SCALING"):
        bench_scaling(cfg, graph, repeats, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
