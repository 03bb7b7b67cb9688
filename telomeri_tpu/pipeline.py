"""End-to-end scaffolding pipeline (SURVEY.md §4.2 call stack).

cli.main -> config -> io.ingest (host) -> graph.tensorize -> [device] walks -> consensus
-> [host] conflict resolution -> stitching -> FASTA. Mirrors the reference's single
`main()` pipeline (SURVEY.md §4.1; mount empty, SURVEY.md §0).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.consensus.evidence import read_diversity_gate
from telomeri_tpu.consensus.grouping import compress, group_and_select, summarize
from telomeri_tpu.graph.tensorize import GraphTensors, tensorize
from telomeri_tpu.io.fasta import SequenceSet, read_fasta, write_fasta
from telomeri_tpu.io.geometry import EdgeSoA, build_edges
from telomeri_tpu.io.paf import PafRecords, parse_paf
from telomeri_tpu.scaffold.bridge import resolve_with_blockers
from telomeri_tpu.scaffold.stitch import Scaffold, Stitcher, emit_scaffolds, extract_path
from telomeri_tpu.utils.logging import Metrics, log
from telomeri_tpu.walk.engine import WalkResult, run_walks_host
from telomeri_tpu.walk.plan import WalkPlan, plan_walks


@dataclass
class PipelineResult:
    scaffolds: list[Scaffold]
    graph: GraphTensors
    edges: EdgeSoA
    plan: WalkPlan
    walks: WalkResult
    bridges: list[dict]
    accepted: list
    metrics: Metrics


def load_inputs(contigs_path: str, reads_path: str, paf_rc_path, paf_rr_path,
                metrics: Metrics | None = None, lazy: str = "auto"):
    """Host ingest: sequences + name table + concatenated PAF rows.

    paf_rc_path / paf_rr_path accept a single path or a list of paths (chunked
    minimap2 runs are common at genome scale); rows keep file-then-line order,
    so the result is deterministic and identical to a pre-concatenated file."""
    as_list = lambda p: [p] if isinstance(p, (str, bytes, os.PathLike)) else list(p)
    metrics = metrics or Metrics()
    with metrics.stage("load_sequences"):
        contigs = read_fasta(contigs_path, lazy=lazy)
        reads = read_fasta(reads_path, lazy=lazy)
    name_index = {n: i for i, n in enumerate(contigs.names)}
    for i, n in enumerate(reads.names):
        if n in name_index:
            raise ValueError(f"read name {n!r} collides with a contig name")
        name_index[n] = len(contigs) + i
    with metrics.stage("parse_paf"):
        paf = PafRecords.concatenate(
            [parse_paf(p, name_index) for p in as_list(paf_rc_path)]
            + [parse_paf(p, name_index) for p in as_list(paf_rr_path)])
    # record which ingest backend actually ran (round-1 verdict: the silent
    # Python fallback hid a missing native build)
    from telomeri_tpu.native.paf_native import available as _native_ok

    backend = "native" if _native_ok() else "python"
    metrics.set("parser_backend", backend)
    if backend == "python":
        log.info("native parser library not built (python -m "
                 "telomeri_tpu.native.build); using the Python parsers")
    return contigs, reads, paf


def build_graph(contigs: SequenceSet, reads: SequenceSet, paf: PafRecords,
                cfg: ScaffoldConfig, metrics: Metrics | None = None):
    metrics = metrics or Metrics()
    n_seqs = len(contigs) + len(reads)
    with metrics.stage("build_edges"):
        edges, fstats = build_edges(paf, cfg, n_seqs)
    metrics.set("filter", fstats.as_dict())
    if cfg.device_scoring != "off":
        import jax

        from telomeri_tpu.io.geometry import rescore_edges_device

        on_device = jax.default_backend() != "cpu"
        # "auto" rescores on the accelerator only at scale: below the threshold
        # the host numpy scores from build_edges stand (same op order; on the
        # GPU the device scores differ by a few ulp — kernels/scoring.py) and
        # the run skips one device compile and the geometry upload. The 32M-edge
        # threshold predates the GPU port and stays until it is measured on the
        # card (ROADMAP.md §1 item 7). "on" forces the device path at any size.
        want = cfg.device_scoring == "on" or (
            on_device and len(edges) >= 32_000_000)
        if want:
            from telomeri_tpu.utils.watchdog import DispatchWatch

            key = f"score_edges:{_pow2_bucket(len(edges))}"
            with metrics.stage("score_edges_device"), \
                    DispatchWatch(metrics).watch(key):
                edges = rescore_edges_device(edges)
            metrics.set("scoring_backend", "jnp")
        else:
            metrics.set("scoring_backend", "numpy")
    with metrics.stage("tensorize"):
        seq_len = np.concatenate([
            contigs.lengths, reads.lengths]) if n_seqs else np.empty(0, np.int64)
        graph = tensorize(edges, seq_len, len(contigs), cfg)
        if cfg.split_read_margin > 0:
            from telomeri_tpu.io.geometry import split_evidence_mask, split_mapped

            graph.split_read = split_mapped(
                paf, n_seqs, min_overlap=cfg.split_read_margin,
                row_mask=split_evidence_mask(paf, cfg.min_identity))
            metrics.set("n_split_reads", int(graph.split_read.sum()))
    metrics.set("graph", graph.stats)
    return edges, graph


def _pow2_bucket(n: int) -> int:
    """Dispatch-history key bucket: sizes within a power of two share history
    (exact sizes would fragment the EWMA; cost scales ~linearly within 2x)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _device_memory_limit(dev) -> int | None:
    """Bytes the backend lets JAX allocate on `dev`, or None where it reports
    no limit (the CPU backend)."""
    return (dev.memory_stats() or {}).get("bytes_limit")


def _resolve_placement(cfg, graph, mesh, metrics):
    """graph_placement="auto": replicated unless the packed walk tables exceed
    ~75% of one device's memory and a multi-device mesh is available (then the
    row-sharded >HBM mode, dist/rowshard.py). Returns the cfg to run walks with.

    An accelerator that reports no memory limit is an error; the CPU backend
    reports none, and there placement stays replicated."""
    import dataclasses

    from telomeri_tpu.walk.engine import device_table_bytes

    if cfg.graph_placement != "auto":
        return cfg
    placement = "replicated"
    if mesh is not None and mesh.size > 1:
        need = device_table_bytes(graph)
        dev = mesh.devices.flat[0]
        limit = _device_memory_limit(dev)
        if not limit and dev.platform != "cpu":
            raise RuntimeError(
                f"{dev.platform} device {dev.device_kind} reports no memory "
                "limit; cannot choose a graph placement (pass "
                "--graph-placement replicated or rowshard)")
        budget = 0.75 * limit if limit else None
        if budget is None:
            log.info("device memory limit unknown on the %s backend: graph "
                     "tables (%.1f GiB) stay replicated", dev.platform,
                     need / 2**30)
        elif need > budget:
            placement = "rowshard"
            log.info(
                "graph tables %.1f GiB exceed 75%% of device memory "
                "(%.1f GiB budget): row-sharding over the %d-device mesh",
                need / 2**30, budget / 2**30, mesh.size)
    metrics.set("graph_placement", placement)
    return dataclasses.replace(cfg, graph_placement=placement)


def run_pipeline(
    contigs_path: str,
    reads_path: str,
    paf_rc_path: str | list[str] | None,
    paf_rr_path: str | list[str] | None,
    out_path: str | None,
    cfg: ScaffoldConfig = ScaffoldConfig(),
    metrics: Metrics | None = None,
    mesh=None,
    graph_artifact: str | None = None,
    save_graph_path: str | None = None,
    walks_artifact: str | None = None,
    save_walks_path: str | None = None,
    trace_dir: str | None = None,
    agp_path: str | None = None,
) -> PipelineResult:
    """Full pipeline. Pass a jax.sharding.Mesh to shard walk batches data-parallel
    (SURVEY.md §4.2); omit it for the single-device path. graph/walks artifacts
    (io/artifacts.py) resume the pipeline from a stage boundary."""
    from telomeri_tpu.io.artifacts import load_graph, load_walks, save_graph, save_walks

    metrics = metrics or Metrics()
    if cfg.graph_placement == "rowshard" and mesh is None:
        raise ValueError("graph_placement='rowshard' shards CSR rows over a "
                         "device mesh; pass --mesh N")
    if cfg.support_mode == "walk_count" and cfg.mc_walks_per_end > 200:
        log.warning(
            "support_mode='walk_count' at %d walks/end: walk-count support is "
            "density-inflated (a chimeric junction gains count as fast as a "
            "real one) — use support_mode='read_diverse' at this density",
            cfg.mc_walks_per_end)
    if graph_artifact:
        with metrics.stage("load_sequences"):
            contigs = read_fasta(contigs_path, lazy=cfg.lazy_sequences)
            reads = read_fasta(reads_path, lazy=cfg.lazy_sequences)
        with metrics.stage("load_graph_artifact"):
            edges, graph = load_graph(graph_artifact, cfg)
        metrics.set("graph", graph.stats)
        if graph.split_read is not None:
            metrics.set("n_split_reads", int(graph.split_read.sum()))
    else:
        contigs, reads, paf = load_inputs(
            contigs_path, reads_path, paf_rc_path, paf_rr_path, metrics,
            lazy=cfg.lazy_sequences)
        edges, graph = build_graph(contigs, reads, paf, cfg, metrics)
        if save_graph_path:
            with metrics.stage("save_graph_artifact"):
                save_graph(save_graph_path, edges, graph, cfg)

    resolved_placement = cfg.graph_placement
    if walks_artifact:
        # resume must ≡ direct: the rescue stage below needs the SAME placement
        # resolution the direct run's walk stage would have made (review r3:
        # 'auto' left unresolved here replicated a >HBM graph in rescue)
        if mesh is not None:
            resolved_placement = _resolve_placement(
                cfg, graph, mesh, metrics).graph_placement
        with metrics.stage("load_walks_artifact"):
            plan, walks = load_walks(walks_artifact, cfg)
        metrics.set("n_walks", plan.n_active)
        with metrics.stage("consensus"):
            summary = summarize(walks, plan.uid, virtual_base=graph.virtual_base)
            cons = group_and_select(
                summary, n_anchors=graph.n_anchors,
                group_window=cfg.group_window, min_support=cfg.min_group_support,
                grouping=cfg.grouping, support=cfg.support_mode)
            bridges = compress(cons)
    else:
        from telomeri_tpu.utils.profiling import maybe_trace

        with metrics.stage("plan_walks"):
            plan = plan_walks(graph, cfg, n_shards=mesh.size if mesh is not None else 1)
        metrics.set("n_walks", plan.n_active)

        from telomeri_tpu.utils.watchdog import DispatchWatch

        walk_key = (f"run_walks:W{_pow2_bucket(max(len(plan), 1))}"
                    f":S{cfg.max_steps}")
        if mesh is not None:
            import jax

            from telomeri_tpu.dist.mesh import run_walks_distributed

            walk_cfg = _resolve_placement(cfg, graph, mesh, metrics)
            resolved_placement = walk_cfg.graph_placement
            with metrics.stage("run_walks"), maybe_trace(trace_dir), \
                    DispatchWatch(metrics).watch(f"{walk_key}:D{mesh.size}"):
                # records stay device-resident and walk-sharded: in a multi-process
                # run they are not host-addressable; the stitch stage fetches only
                # the representative rows (dist.fetch_walk_rows)
                walks, cons = run_walks_distributed(graph, plan, walk_cfg, mesh)
                jax.block_until_ready(cons)  # the dispatch watch must see real time
            with metrics.stage("consensus"):
                bridges = compress(cons)
        else:
            with metrics.stage("run_walks"), maybe_trace(trace_dir), \
                    DispatchWatch(metrics).watch(walk_key):
                walks = run_walks_host(graph, plan, cfg)
            with metrics.stage("consensus"):
                summary = summarize(walks, plan.uid,
                                    virtual_base=graph.virtual_base)
                cons = group_and_select(
                    summary, n_anchors=graph.n_anchors,
                    group_window=cfg.group_window,
                    min_support=cfg.min_group_support, grouping=cfg.grouping,
                    support=cfg.support_mode)
                bridges = compress(cons)
        if save_walks_path:
            import jax

            if mesh is not None and jax.process_count() > 1:
                log.warning("--save-walks skipped: records are sharded across "
                            "processes; rerun single-process to save them")
            else:
                with metrics.stage("save_walks_artifact"):
                    save_walks(save_walks_path, plan, walks, cfg)
    import jax.numpy as jnp

    n_succ = int(np.asarray(jnp.sum(walks.success)))  # works on sharded records too
    metrics.set("n_walks_successful", n_succ)
    # truncated = ran to the step bound without reaching an anchor: the signal for
    # sizing max_steps (SURVEY.md §7 "walk divergence"). A high share means real
    # bridge paths may be longer than the bound allows.
    n_trunc = int(np.asarray(jnp.sum(
        (walks.steps >= cfg.max_steps) & ~walks.success)))
    metrics.set("n_walks_truncated", n_trunc)
    log.info("walks: %d planned, %d successful, %d truncated at max_steps=%d",
             plan.n_active, n_succ, n_trunc, cfg.max_steps)
    if plan.n_active and n_trunc > 0.2 * plan.n_active:
        log.warning(
            "%.0f%% of walks truncated at max_steps=%d — real bridge paths may "
            "be longer; consider raising --max-steps",
            100 * n_trunc / plan.n_active, cfg.max_steps)
    metrics.set("n_bridges_candidate", len(bridges))

    # cut-read gate (consensus/evidence.py): a bridge whose distinct paths all
    # share one read is single-point evidence; split-read mapping geometry
    # tells clean spanning reads (accept) from chimera suspects (block)
    blocked_rows: list = []
    if cfg.support_mode == "read_diverse":
        with metrics.stage("cut_read_gate"):
            bridges, blocked_rows = read_diversity_gate(
                bridges, cons, walks, graph.virtual_base, mesh=mesh,
                split_read=graph.split_read)
        metrics.set("n_bridges_cut_refused", len(blocked_rows))
        metrics.set("n_bridges_cut_clean",
                    sum(1 for r in bridges if "cut_reads" in r))
        if blocked_rows:
            log.info("cut-read gate: %d candidate bridge(s) refused on "
                     "single-point evidence (their winning ends stay blocked)",
                     len(blocked_rows))
        # copy-coherence demotion (consensus/coherence.py): pairs whose every
        # distinct path carries a cross-copy-signature edge rank below
        # coherent pairs at equal count in conflict resolution
        if cfg.copy_coherence_margin > 0:
            from telomeri_tpu.consensus.coherence import annotate_pair_coherence

            with metrics.stage("coherence"):
                n_inc = annotate_pair_coherence(
                    bridges, cons, walks, edges, graph.virtual_base,
                    cfg.copy_coherence_margin, mesh=mesh)
            metrics.set("n_pairs_incoherent", n_inc)
            if n_inc:
                log.info("coherence: %d of %d candidate pair(s) have no "
                         "distinct path clear of cross-copy-signature edges; "
                         "demoted in conflict order", n_inc, len(bridges))

    with metrics.stage("resolve_conflicts"):
        accepted, blocked_ends = resolve_with_blockers(bridges, blocked_rows)
    metrics.set("n_bridges_accepted", len(accepted))
    metrics.set("n_ends_blocked", len(blocked_ends))
    log.info("bridges: %d candidates, %d accepted", len(bridges), len(accepted))

    # rescue rounds (walk/rescue.py): dense re-walks of still-free walkable
    # ends, accepted only on read-diverse evidence; can only ADD bridges
    rescue_paths: dict = {}
    if cfg.rescue_rounds > 0:   # also on --walks resume: resume must ≡ direct
        from telomeri_tpu.utils.watchdog import DispatchWatch
        from telomeri_tpu.walk.rescue import free_walkable_ends, run_rescue_round

        rescue_gd = None   # replicated-path device tables, uploaded ONCE
        for ri in range(cfg.rescue_rounds):
            if not free_walkable_ends(graph, accepted, blocked_ends):
                break
            if rescue_gd is None and resolved_placement != "rowshard":
                from telomeri_tpu.walk.engine import graph_to_device

                if mesh is not None:
                    from telomeri_tpu.dist.mesh import replicated

                    rescue_gd = graph_to_device(graph, replicated(mesh))
                else:
                    rescue_gd = graph_to_device(graph)
            key = f"rescue_walks:R{ri}"
            with metrics.stage(f"rescue_round_{ri}"), \
                    DispatchWatch(metrics).watch(key):
                new, paths_ri, blocked_ends = run_rescue_round(
                    graph, cfg, accepted, ri, gd=rescue_gd, mesh=mesh,
                    placement=resolved_placement, blocked_ends=blocked_ends)
            if not new:
                break
            accepted = accepted + new
            rescue_paths.update(paths_ri)
            log.info("rescue round %d: %d additional bridges accepted", ri,
                     len(new))
        metrics.set("n_bridges_rescued", len(rescue_paths))
        metrics.set("n_bridges_accepted", len(accepted))  # incl. rescued

    with metrics.stage("stitch"):
        lut = plan.uid_to_row()
        # rescue bridges carry their own extracted paths (separate records)
        rep_uids = [b.rep_uid for b in accepted if b.rep_uid not in rescue_paths]
        # the device gather is only for records that are NOT host-addressable
        # (device-resident + walk-sharded, i.e. the walk stage ran under a mesh
        # this run); host-numpy records — single-device runs and --walks artifact
        # resumes — use plain indexing
        if mesh is not None and not isinstance(walks.nodes, np.ndarray):
            from telomeri_tpu.dist.mesh import fetch_walk_rows

            mini = fetch_walk_rows(
                walks, np.array([lut[u] for u in rep_uids], np.int64), mesh)
            paths = {
                u: extract_path(mini.nodes[i], mini.eids[i], int(mini.steps[i]),
                                virtual_base=graph.virtual_base)
                for i, u in enumerate(rep_uids)
            }
        else:
            wn = np.asarray(walks.nodes)
            we = np.asarray(walks.eids)
            ws = np.asarray(walks.steps)
            paths = {
                u: extract_path(wn[lut[u]], we[lut[u]], int(ws[lut[u]]),
                                virtual_base=graph.virtual_base)
                for u in rep_uids
            }
        paths.update(rescue_paths)
        stitcher = Stitcher(contigs, reads, edges)
        scaffolds = emit_scaffolds(accepted, paths, stitcher)

    # junction polish (scaffold/polish.py): re-call fill bases by plurality
    # over each junction's spanning reads. Gate-kept rows carry the pair's
    # spanning-read set (span_reads); rescue bridges (and walk_count mode)
    # fall back to the representative path's own interior reads, whose votes
    # exclude the segment's source read — conservative by construction.
    if cfg.polish:
        from telomeri_tpu.scaffold.polish import polish_scaffolds

        junction_reads = {tuple(r["pair"]): r["span_reads"]
                          for r in bridges if "span_reads" in r}
        for b in accepted:
            if tuple(b.pair) not in junction_reads:
                wp = paths.get(b.rep_uid)
                if wp is not None:
                    junction_reads[tuple(b.pair)] = sorted(
                        {n // 2 for n in wp.nodes[1:-1]
                         if n // 2 >= len(contigs)})
        with metrics.stage("polish"):
            agg = polish_scaffolds(scaffolds, reads, junction_reads,
                                   len(contigs), flank=cfg.polish_flank,
                                   log=log)
        metrics.set("polish", agg)
    metrics.set("n_scaffolds", len(scaffolds))
    metrics.set("scaffold_lengths", [int(len(s.seq)) for s in scaffolds])
    from telomeri_tpu.utils.stats import scaffold_vs_contig_stats

    metrics.set("assembly", scaffold_vs_contig_stats(
        [len(s.seq) for s in scaffolds], list(contigs.lengths)))

    if out_path:
        with metrics.stage("write_fasta"):
            write_fasta(out_path, [s.name for s in scaffolds], [s.seq for s in scaffolds])
    if agp_path:
        from telomeri_tpu.scaffold.stitch import write_agp

        with metrics.stage("write_agp"):
            write_agp(agp_path, scaffolds, contigs, reads)

    return PipelineResult(
        scaffolds=scaffolds, graph=graph, edges=edges, plan=plan, walks=walks,
        bridges=bridges, accepted=accepted, metrics=metrics,
    )
