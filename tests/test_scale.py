"""Scale tests.

test_many_junction_genome — mid-scale end-to-end regression (BASELINE.md config #2
analog, quarter scale): many repeat junctions, PacBio-like error rate,
single-scaffold reconstruction. Runs in the default suite.

test_ecoli_preset_end_to_end — the full E. coli-scale preset (4.6 Mb). Minutes-long,
so it only runs when TELOMERI_SCALE_TEST=1; on the GPU the same preset runs through
the CLI in chip_smoke.py (phase 2).
"""

import os

import numpy as np
import pytest

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.pipeline import run_pipeline
from telomeri_tpu.sim import PRESETS, SimConfig, simulate, write_dataset


def test_many_junction_genome(tmp_path):
    sim = simulate(SimConfig(
        genome_len=1_200_000, repeat_len=4_000, n_repeat_copies=8,
        read_len_mean=7_000, read_len_sd=1_500, read_min_len=1_000,
        coverage=16.0, error_rate=0.05, min_sim_overlap=500, seed=11))
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    out = str(tmp_path / "s.fa")
    res = run_pipeline(
        f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
        f"{d}/read2read.paf", out,
        ScaffoldConfig(mc_walks_per_end=200, max_steps=32))
    assert len(res.accepted) == 8, [b.pair for b in res.accepted]
    assert len(res.scaffolds) == 1
    sc = res.scaffolds[0].seq
    assert len(sc) == len(sim.genome)
    assert float(np.mean(sc == sim.genome)) > 0.99
    m = res.metrics.as_dict()["metrics"]
    assert m["assembly"]["scaffolds"]["n50"] == len(sim.genome)


def test_indel_reads_end_to_end(tmp_path):
    """Round-2 realism regression (VERDICT item 1): indel-bearing reads with
    jittered minimap2-style endpoints must still bridge every repeat, and the
    alignment-based validator must confirm >= 98% identity with healthy
    junctions (positional identity is meaningless on this data)."""
    from telomeri_tpu.utils.validate import junctions_from_segments, validate_assembly

    sim = simulate(SimConfig(
        genome_len=400_000, repeat_len=4_000, n_repeat_copies=4,
        read_len_mean=5_000, read_len_sd=1_000, read_min_len=800,
        coverage=16.0, error_rate=0.02, ins_rate=0.025, del_rate=0.025,
        end_jitter=25, min_sim_overlap=400, seed=23))
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    res = run_pipeline(
        f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
        f"{d}/read2read.paf", str(tmp_path / "s.fa"),
        ScaffoldConfig(mc_walks_per_end=200, max_steps=32))
    assert len(res.accepted) == 4, [b.pair for b in res.accepted]
    assert len(res.scaffolds) == 1
    sc = res.scaffolds[0]
    # indel drift: length close to, but not exactly, the genome length
    assert abs(len(sc.seq) - len(sim.genome)) < 0.005 * len(sim.genome)
    from telomeri_tpu.io.fasta import SequenceSet

    rep = validate_assembly(
        SequenceSet([sc.name], [sc.seq]), SequenceSet(["g"], [sim.genome]),
        junctions={sc.name: junctions_from_segments(sc.segments)})
    assert rep["n_placed"] == 1
    assert rep["mean_identity"] > 0.98
    # junction windows are read-filled sequence at ~7% error; a misjoin would
    # crater one of them toward ~0.5
    assert rep["worst_junction_identity"] > 0.85


def _validate(res, sim):
    from telomeri_tpu.io.fasta import SequenceSet
    from telomeri_tpu.utils.validate import junctions_from_segments, validate_assembly

    return validate_assembly(
        SequenceSet([s.name for s in res.scaffolds], [s.seq for s in res.scaffolds]),
        SequenceSet(["g"], [sim.genome]),
        junctions={s.name: junctions_from_segments(s.segments)
                   for s in res.scaffolds})


def test_cross_copy_spanning_reads(tmp_path):
    """Cross-copy repeat overlaps (sim.py round 2): reads LONGER than the repeat
    anchor in unique flanks, so correct bridges win despite wrong-copy edges and
    raw-read error. Also exercises hierarchical hub rows on a realistic graph."""
    sim = simulate(SimConfig(
        genome_len=240_000, repeat_len=4_000, n_repeat_copies=3,
        read_len_mean=5_000, read_len_sd=1_000, read_min_len=800,
        coverage=16.0, error_rate=0.02, ins_rate=0.025, del_rate=0.025,
        end_jitter=25, min_sim_overlap=400, cross_copy_overlaps=True, seed=23))
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    res = run_pipeline(
        f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
        f"{d}/read2read.paf", None,
        ScaffoldConfig(mc_walks_per_end=200, max_steps=32))
    assert {b.pair for b in res.accepted} == {(0, 2), (2, 4), (4, 6)}
    assert len(res.scaffolds) == 1
    rep = _validate(res, sim)
    assert rep["mean_identity"] > 0.98
    assert rep["worst_junction_identity"] > 0.85


def test_cross_copy_interior_paths_corrected_reads(tmp_path):
    """The HERA regime: repeats 3x LONGER than any read, so bridges chain
    multiple interior reads, and cross-copy edges would teleport walks between
    copies. With corrected-read error (<1%) below the copy divergence (4%),
    min_identity=0.97 separates same-copy from cross-copy overlaps — the
    mechanism that makes the problem solvable at all (with byte-identical
    copies it is information-theoretically unsolvable; see sim.py docstring).
    Regression for round-1 verdict items 2-4 jointly: windowed grouping +
    hierarchical hubs + realistic ambiguity."""
    sim = simulate(SimConfig(
        genome_len=300_000, repeat_len=8_000, n_repeat_copies=4,
        read_len_mean=2_500, read_len_sd=400, read_min_len=800,
        coverage=24.0, error_rate=0.005, ins_rate=0.0025, del_rate=0.0025,
        end_jitter=10, min_sim_overlap=300, cross_copy_overlaps=True,
        copy_divergence=0.04, seed=5))
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    res = run_pipeline(
        f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
        f"{d}/read2read.paf", None,
        ScaffoldConfig(mc_walks_per_end=400, max_steps=48, min_identity=0.97))
    # the identity filter must actually reject a large cross-copy population
    assert res.metrics.as_dict()["metrics"]["filter"]["n_low_identity"] > 5_000
    assert {b.pair for b in res.accepted} == {(0, 2), (2, 4), (4, 6), (6, 8)}
    assert len(res.scaffolds) == 1
    rep = _validate(res, sim)
    assert rep["mean_identity"] > 0.99
    assert rep["worst_junction_identity"] > 0.95


@pytest.mark.slow
@pytest.mark.skipif(
    not os.environ.get("TELOMERI_SCALE_TEST"),
    reason="set TELOMERI_SCALE_TEST=1 (minutes-long)")
def test_ecoli_preset_end_to_end(tmp_path):
    from telomeri_tpu.io.fasta import read_fasta
    from telomeri_tpu.utils.validate import validate_assembly

    d = str(tmp_path)
    write_dataset(simulate(PRESETS["ecoli"]), d)
    cfg = ScaffoldConfig(mc_walks_per_end=64)  # scaled down for the CPU backend
    out = os.path.join(d, "scaffolds.fa")
    res = run_pipeline(
        os.path.join(d, "contigs.fa"), os.path.join(d, "reads.fa"),
        os.path.join(d, "read2contig.paf"), os.path.join(d, "read2read.paf"),
        out, cfg)
    scaf = read_fasta(out)
    # every gap bridged -> one scaffold reconstructing the genome (the ecoli
    # preset now carries indels, so identity comes from the aligner)
    assert len(scaf) == 1
    genome = read_fasta(os.path.join(d, "genome.fa"))
    rep = validate_assembly(scaf, genome, stride=64)
    assert rep["n_placed"] == 1
    assert rep["mean_identity"] > 0.98


def test_repeats_longer_than_reads(tmp_path):
    """HERA's core claim: repeats much LONGER than any single read are resolved
    by multi-read path walks + length-histogram consensus. Repeat copies are
    exact, so a misjoin between copies would corrupt flank order — full-genome
    byte reconstruction proves every junction was paired correctly."""
    sim = simulate(SimConfig(
        genome_len=150_000, repeat_len=12_000, n_repeat_copies=3,
        read_len_mean=1_500, read_len_sd=200, coverage=18.0,
        error_rate=0.02, seed=42))
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    res = run_pipeline(
        f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
        f"{d}/read2read.paf", str(tmp_path / "s.fa"),
        ScaffoldConfig(mc_walks_per_end=200, max_steps=32))
    assert len(res.scaffolds) == 1
    sc = res.scaffolds[0].seq
    assert len(sc) == len(sim.genome)
    assert float(np.mean(sc == sim.genome)) > 0.99


def test_chimera_dropout_no_misjoin(tmp_path):
    """Misjoin bait (VERDICT r2 item 5): chimeric reads produce PAF rows joining
    DISJOINT loci, and a coverage dropout over one repeat junction removes the
    true bridge there — exactly the situation where a naive scaffolder stitches
    a chimera into a misjoin. The pipeline must (a) leave the dropout gap
    honestly unbridged, (b) accept only genome-adjacent bridges. The naive
    control (min_group_support=1) on the same data DOES accept a chimeric
    bridge, proving the bait is real and the support rule is what rejects it."""
    import dataclasses

    # dropout (33800, 43800) covers repeat copy 0 (starts 36800) + both flanks:
    # no read spans the ctg0-ctg1 junction. seed=3 pinned: its random chimeras
    # connect the free ends 0L/4R strongly enough to win a support-1 consensus.
    sim = simulate(SimConfig(
        genome_len=200_000, repeat_len=4_000, n_repeat_copies=4,
        read_len_mean=3_000, read_len_sd=500, coverage=15.0,
        error_rate=0.02, chimera_rate=0.2,
        dropout_len=10_000, dropout_starts=(33_800,), seed=3))
    assert sim.chimeric
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    args = (f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
            f"{d}/read2read.paf")
    cfg = ScaffoldConfig(mc_walks_per_end=64, max_steps=16)

    res = run_pipeline(*args, str(tmp_path / "s.fa"), cfg)
    n_anchors = 5
    adjacent = {(2 * c, 2 * c + 2) for c in range(n_anchors - 1)}
    pairs = {b.pair for b in res.accepted}
    assert pairs <= adjacent, f"misjoin accepted: {sorted(pairs - adjacent)}"
    assert (0, 2) not in pairs, "the dropout gap (ctg0-ctg1) cannot have a real bridge"
    assert len(pairs) == 3, pairs   # every other gap bridged
    assert len(res.scaffolds) == 2  # the dropout splits the genome in two

    # naive control: legacy walk-count support at threshold 1 accepts a
    # chimeric (non-adjacent) bridge — the bait is real
    naive = run_pipeline(*args, str(tmp_path / "naive.fa"),
                         dataclasses.replace(cfg, min_group_support=1,
                                             support_mode="walk_count"))
    naive_pairs = {b.pair for b in naive.accepted}
    assert naive_pairs - adjacent, \
        "bait did not fire: naive walk-count consensus accepted no chimeric bridge"

    # round-4 regression: with read-diverse support the cut-read gate ALONE
    # refuses the chimera even at threshold 1 (every path through the fake
    # junction contains the chimeric read), so density can rise freely
    gated = run_pipeline(*args, str(tmp_path / "gated.fa"),
                         dataclasses.replace(cfg, min_group_support=1))
    gated_pairs = {b.pair for b in gated.accepted}
    assert gated_pairs <= adjacent, \
        f"cut-read gate missed a chimera at support 1: {sorted(gated_pairs - adjacent)}"
    assert gated.metrics.values.get("n_bridges_cut_refused", 0) > 0, \
        "the gate never fired on the chimera bait"


def test_rescue_round_bridges_undersampled_gap(tmp_path):
    """Rescue rounds (walk/rescue.py): at starvation walk density the base
    consensus misses a multi-read repeat path; the rescue round re-walks the
    free ends densely and accepts the bridge on READ-DIVERSE evidence
    (>= min_group_support distinct paths, no cut read) — without flipping any
    base decision or introducing a misjoin. Mirrors the hg002-sub root cause
    (BASELINE.md gap table: 3 of 4 missed gaps were samplable at 2000/end)."""
    import dataclasses

    sim = simulate(SimConfig(
        genome_len=220_000, repeat_len=12_000, n_repeat_copies=3,
        read_len_mean=2_200, read_len_sd=300, coverage=14.0,
        error_rate=0.02, cross_copy_overlaps=True, copy_divergence=0.02,
        seed=2))
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    args = (f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
            f"{d}/read2read.paf")
    base_cfg = ScaffoldConfig(mc_walks_per_end=3, max_steps=32, rescue_rounds=0)
    r0 = run_pipeline(*args, str(tmp_path / "o0.fa"), base_cfg)
    cfg = dataclasses.replace(base_cfg, rescue_rounds=1,
                              rescue_walks_per_end=800)
    r1 = run_pipeline(*args, str(tmp_path / "o1.fa"), cfg)

    adjacent = {(2 * c, 2 * c + 2) for c in range(3)}
    assert len(r0.accepted) == 2          # base density misses one gap
    assert len(r1.accepted) == 3          # rescue adds exactly the missing one
    assert r1.metrics.values["n_bridges_rescued"] == 1
    assert {b.pair for b in r1.accepted} == adjacent   # no misjoin
    # base decisions unchanged (rescue is subordinate)
    assert {b.pair for b in r0.accepted} <= {b.pair for b in r1.accepted}
    assert len(r1.scaffolds) == 1 and len(r0.scaffolds) == 2
    # deterministic: a rerun writes byte-identical output
    r2 = run_pipeline(*args, str(tmp_path / "o2.fa"), cfg)
    assert open(tmp_path / "o1.fa", "rb").read() == \
        open(tmp_path / "o2.fa", "rb").read()


def test_containment_heavy_reads(tmp_path):
    """Adversarial containment chains (VERDICT r2 missing #4): a bimodal-ish
    read set where ~40% of PAF rows are containments (short reads nested in
    long ones). Contained overlaps carry no extension signal and are dropped
    by the geometry filter; the pipeline must still bridge every gap from the
    surviving dovetails and reconstruct the genome."""
    sim = simulate(SimConfig(
        genome_len=150_000, repeat_len=3_000, n_repeat_copies=3,
        read_len_mean=2_500, read_len_sd=1_800, read_min_len=300,
        coverage=25.0, error_rate=0.02, seed=8))
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    res = run_pipeline(
        f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
        f"{d}/read2read.paf", str(tmp_path / "s.fa"),
        ScaffoldConfig(mc_walks_per_end=100, max_steps=24))
    m = res.metrics.as_dict()["metrics"]["filter"]
    assert m["n_contained"] > 10_000          # the chains are really present
    assert {b.pair for b in res.accepted} == {(0, 2), (2, 4), (4, 6)}
    assert len(res.scaffolds) == 1
    sc = res.scaffolds[0].seq
    assert len(sc) == len(sim.genome)
    assert float(np.mean(sc == sim.genome)) > 0.99


def test_rescue_round_mesh_parity(tmp_path):
    """A rescue round firing under a device mesh (replicated AND rowshard
    placements) must write the same FASTA as the 1-device run — rescue walks
    are uid-keyed and placement-invariant."""
    import dataclasses

    from telomeri_tpu.dist.mesh import make_walk_mesh

    sim = simulate(SimConfig(
        genome_len=220_000, repeat_len=12_000, n_repeat_copies=3,
        read_len_mean=2_200, read_len_sd=300, coverage=14.0,
        error_rate=0.02, cross_copy_overlaps=True, copy_divergence=0.02,
        seed=2))
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    args = (f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
            f"{d}/read2read.paf")
    cfg = ScaffoldConfig(mc_walks_per_end=3, max_steps=32, rescue_rounds=1,
                         rescue_walks_per_end=800)
    r1 = run_pipeline(*args, str(tmp_path / "one.fa"), cfg)
    assert r1.metrics.values["n_bridges_rescued"] == 1   # rescue really fires
    mesh = make_walk_mesh(8)
    run_pipeline(*args, str(tmp_path / "mesh.fa"), cfg, mesh=mesh)
    run_pipeline(*args, str(tmp_path / "rs.fa"),
                 dataclasses.replace(cfg, graph_placement="rowshard"),
                 mesh=mesh)
    one = open(tmp_path / "one.fa", "rb").read()
    assert one == open(tmp_path / "mesh.fa", "rb").read()
    assert one == open(tmp_path / "rs.fa", "rb").read()


def _fwd_or_rc_identity(sc: np.ndarray, genome: np.ndarray) -> float:
    from telomeri_tpu.io.fasta import reverse_complement

    if len(sc) != len(genome):
        return 0.0
    return max(float(np.mean(sc == genome)),
               float(np.mean(reverse_complement(sc) == genome)))


def test_inverted_repeat_bridging(tmp_path):
    """Round 4 (VERDICT r3 missing #4): repeat copies planted as REVERSE
    COMPLEMENTS of the master. Cross-copy rows between normal and inverted
    copies are strand-flipped with mirrored coordinates — the orientation
    symmetry of the oriented-node graph that same-orientation suites never
    exercise. Every gap must bridge to its genome-adjacent contig (an
    orientation bug pairs wrong ends or crashes identity to ~50%)."""
    # corrected-read regime (cf. test_cross_copy_interior_paths_corrected_reads):
    # reads shorter than the repeat walk MULTI-READ interior paths through the
    # inverted copies, and min_identity=0.97 over 4% divergence removes the
    # cross-copy teleport web — with the web intact and interior-only reads,
    # wrong-copy bridges are length-identical to true ones for ANY scaffolder
    # (sim.py docstring)
    sim = simulate(SimConfig(
        genome_len=300_000, repeat_len=8_000, n_repeat_copies=4,
        read_len_mean=2_500, read_len_sd=400, read_min_len=800, coverage=24.0,
        error_rate=0.005, ins_rate=0.0025, del_rate=0.0025, end_jitter=10,
        min_sim_overlap=300, cross_copy_overlaps=True, copy_divergence=0.04,
        inverted_copies=(1, 3), seed=21))
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    res = run_pipeline(
        f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
        f"{d}/read2read.paf", str(tmp_path / "s.fa"),
        ScaffoldConfig(mc_walks_per_end=400, max_steps=48, min_identity=0.97))
    adjacent = {(2 * c, 2 * c + 2) for c in range(4)}
    pairs = {b.pair for b in res.accepted}
    assert pairs == adjacent, f"misjoin/missing across inverted copies: {pairs}"
    assert len(res.scaffolds) == 1
    rep = _validate(res, sim)
    assert rep["mean_identity"] > 0.99
    assert rep["worst_junction_identity"] > 0.9


def test_tandem_array_no_misjoin(tmp_path):
    """Tandem blocks: two back-to-back copies with NO unique sequence between
    them — the scaffolder must bridge a DOUBLE-length repeat block (2L > 2x
    read length) without stitching wrong copies together."""
    sim = simulate(SimConfig(
        genome_len=260_000, repeat_len=4_000, n_repeat_copies=6,
        tandem_pairs=2, read_len_mean=2_500, read_len_sd=300, read_min_len=800,
        coverage=24.0, error_rate=0.005, ins_rate=0.0025, del_rate=0.0025,
        end_jitter=10, min_sim_overlap=300, cross_copy_overlaps=True,
        copy_divergence=0.04, seed=22))
    assert len(sim.contigs) == 5        # 4 blocks (2 tandem + 2 single) + 1
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    res = run_pipeline(
        f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
        f"{d}/read2read.paf", str(tmp_path / "s.fa"),
        ScaffoldConfig(mc_walks_per_end=400, max_steps=48, min_identity=0.97))
    adjacent = {(2 * c, 2 * c + 2) for c in range(4)}
    pairs = {b.pair for b in res.accepted}
    assert pairs <= adjacent, f"misjoin in tandem array: {pairs - adjacent}"
    assert pairs == adjacent, f"unbridged tandem gap: {adjacent - pairs}"
    assert len(res.scaffolds) == 1
    rep = _validate(res, sim)
    assert rep["mean_identity"] > 0.99
    assert rep["worst_junction_identity"] > 0.9


def test_het_bubbles_no_misjoin(tmp_path):
    """Heterozygous SNP bubbles: reads drawn from two haplotypes. The bubble
    noise must not fragment the scaffold or create misjoins; identity vs the
    hap-0 truth dips only by the het rate."""
    # reads LONGER than the repeat (overhang rules thin the cross-copy web,
    # cf. test_cross_copy_spanning_reads) + het bubbles on top
    sim = simulate(SimConfig(
        genome_len=150_000, repeat_len=3_000, n_repeat_copies=3,
        read_len_mean=5_000, read_len_sd=800, read_min_len=800, coverage=16.0,
        error_rate=0.02, het_rate=0.002, cross_copy_overlaps=True,
        copy_divergence=0.02, seed=23))
    assert sim.het_pos.size > 50
    d = str(tmp_path / "data")
    write_dataset(sim, d)
    res = run_pipeline(
        f"{d}/contigs.fa", f"{d}/reads.fa", f"{d}/read2contig.paf",
        f"{d}/read2read.paf", str(tmp_path / "s.fa"),
        ScaffoldConfig(mc_walks_per_end=200, max_steps=32))
    adjacent = {(2 * c, 2 * c + 2) for c in range(3)}
    pairs = {b.pair for b in res.accepted}
    assert pairs == adjacent, pairs
    assert len(res.scaffolds) == 1
    ident = _fwd_or_rc_identity(res.scaffolds[0].seq, sim.genome)
    assert ident > 0.97, ident
