"""Tests for the indel-tolerant scaffold validator (utils/validate.py)."""

import os

import numpy as np

from telomeri_tpu.io.fasta import SequenceSet, reverse_complement
from telomeri_tpu.utils.validate import (
    junctions_from_segments,
    place_scaffold,
    read_agp_junctions,
    validate_assembly,
)


def _rand_seq(n, seed):
    rng = np.random.default_rng(seed)
    return np.frombuffer(rng.choice(list(b"ACGT"), size=n).astype(np.uint8)
                         .tobytes(), dtype=np.uint8)


def _indel_mutate(seq, seed, sub=0.01, ins=0.01, dele=0.01):
    rng = np.random.default_rng(seed)
    out = []
    for b in seq:
        if rng.random() < dele:
            continue
        if rng.random() < sub:
            out.append(ord("ACGT"[(b"ACGT".index(bytes([b])) + 1) % 4]))
        else:
            out.append(int(b))
        if rng.random() < ins:
            out.append(ord("ACGT"[rng.integers(0, 4)]))
    return np.array(out, np.uint8)


def test_forward_placement_exact():
    g = _rand_seq(5000, 0)
    p = place_scaffold("s", g[1000:3000].copy(), {"g": g})
    assert (p.genome, p.strand, p.offset) == ("g", 1, 1000)
    assert p.identity == 1.0 and p.span == 2000


def test_reverse_placement():
    g = _rand_seq(5000, 1)
    rc = reverse_complement(g[1000:3000])
    p = place_scaffold("s", rc, {"g": g})
    assert p.genome == "g" and p.strand == -1
    assert p.identity == 1.0 and p.span == 2000


def test_placement_with_substitutions():
    g = _rand_seq(8000, 2)
    s = g[500:7500].copy()
    rng = np.random.default_rng(3)
    bad = rng.choice(len(s), size=len(s) // 50, replace=False)   # 2% errors
    s[bad] = np.where(s[bad] == ord("A"), ord("C"), ord("A")).astype(np.uint8)
    p = place_scaffold("s", s, {"g": g})
    assert p.genome == "g" and 0.97 < p.identity < 1.0


def test_placement_with_indels():
    """The round-1 positional validator collapsed to ~25% on ONE indel; the
    aligner must report true identity on 3%-indel sequence (VERDICT item 1)."""
    g = _rand_seq(20_000, 12)
    s = _indel_mutate(g[1000:19000], seed=13, sub=0.01, ins=0.01, dele=0.01)
    p = place_scaffold("s", s, {"g": g})
    assert p.genome == "g" and p.strand == 1
    assert 0.96 < p.identity < 0.985   # ~3% total error


def test_misjoin_collapses_identity():
    # scaffold = first half of g glued to a segment from the WRONG place
    g = _rand_seq(10000, 4)
    s = np.concatenate([g[0:4000], g[7000:10000]])
    p = place_scaffold("s", s, {"g": g})
    assert p.genome == "g"
    assert p.identity < 0.75   # the 3 kb genome skip is charged as edits


def test_unplaced_scaffold():
    g = _rand_seq(5000, 5)
    alien = _rand_seq(2000, 6)
    p = place_scaffold("s", alien, {"g": g})
    assert p.genome is None and p.identity == 0.0


def test_validate_assembly_report():
    g = _rand_seq(6000, 7)
    scaffolds = SequenceSet(["a", "b"], [g[0:3000].copy(), g[3000:6000].copy()])
    genomes = SequenceSet(["g"], [g])
    rep = validate_assembly(scaffolds, genomes)
    assert rep["n_placed"] == 2 and rep["placed_fraction"] == 1.0
    assert rep["mean_identity"] == 1.0 and rep["worst_identity"] == 1.0


def test_repeat_seed_does_not_misplace():
    """Anchors inside a repeat are non-unique and skipped; placement must come
    from unique flanking sequence, not false-alarm on the wrong copy."""
    R = _rand_seq(200, 9)
    A = _rand_seq(3000, 10)
    B = _rand_seq(3000, 11)
    g = np.concatenate([R, A, R, B])          # repeat at 0 and 3200
    s = g[3200:].copy()                       # scaffold starts INSIDE repeat copy 2
    p = place_scaffold("s", s, {"g": g})
    assert p.identity == 1.0 and p.strand == 1
    assert p.offset == 3200


def test_junction_identities_flag_misjoin():
    """Whole-scaffold identity dilutes a single bad junction on a long scaffold;
    the per-junction windows must flag it (VERDICT round 1 weak item 5)."""
    g = _rand_seq(60_000, 14)
    good = g[0:30_000]
    bad_tail = g[45_000:55_000]               # misjoined: skips 15 kb
    s = np.concatenate([good, bad_tail])
    scaffolds = SequenceSet(["s"], [s])
    genomes = SequenceSet(["g"], [g])
    rep = validate_assembly(
        scaffolds, genomes,
        junctions={"s": [10_000, 30_000]}, junction_window=2000)
    j = {r["pos"]: r["identity"] for r in rep["placements"][0]["junctions"]}
    assert j[10_000] > 0.95                   # healthy junction
    assert j[30_000] < 0.6                    # the misjoin
    assert rep["worst_junction_identity"] < 0.6
    assert rep["n_misjoins"] == 1


def test_junctions_from_segments_and_agp(tmp_path):
    segs = [("contig", 0, 0, 0, 0, 1000), ("read", 5, 1, 100, 1000, 500),
            ("contig", 1, 0, 0, 1500, 800)]
    assert junctions_from_segments(segs) == [1000, 1500]
    agp = tmp_path / "x.agp"
    agp.write_text("##agp-version\t2.1\n"
                   "s1\t1\t1000\t1\tW\tctg000\t1\t1000\t+\n"
                   "s1\t1001\t1500\t2\tW\tread5\t1\t500\t-\n"
                   "s2\t1\t700\t1\tW\tctg001\t1\t700\t+\n")
    assert read_agp_junctions(str(agp)) == {"s1": [1000]}


def test_sampled_validation_accuracy_and_exact_junctions():
    """--sample mode: whole-scaffold identity becomes a rate estimate with
    error bars, but junction windows (the misjoin signal) stay EXACT."""
    g = _rand_seq(200_000, 21)
    s = _indel_mutate(g, 22, sub=0.01, ins=0.003, dele=0.003)
    scaffolds = SequenceSet(["s"], [s])
    genomes = SequenceSet(["g"], [g])
    full = validate_assembly(scaffolds, genomes, junctions={"s": [100_000]})
    samp = validate_assembly(scaffolds, genomes, junctions={"s": [100_000]},
                             sample=8)
    assert samp["sampled"] is True
    pl = samp["placements"][0]
    assert 0 < pl["sampled_fraction"] < 0.6
    assert pl["identity_stderr"] > 0
    # estimate lands within a small absolute band of the exact identity
    assert abs(samp["mean_identity"] - full["mean_identity"]) < 0.002
    # junction identity: byte-exact between modes (window segments forced exact)
    jf = full["placements"][0]["junctions"][0]["identity"]
    js = pl["junctions"][0]["identity"]
    assert jf == js


def test_sampled_validation_still_flags_misjoin():
    """Sampling must never hide a misjoin: the giant-gap (giveup) segments are
    costed directly and junction windows are exact."""
    g = _rand_seq(120_000, 23)
    s = np.concatenate([g[0:40_000], g[90_000:110_000]])  # skips 50 kb
    rep = validate_assembly(SequenceSet(["s"], [s]), SequenceSet(["g"], [g]),
                            junctions={"s": [40_000]}, sample=8)
    assert rep["worst_junction_identity"] < 0.6
    assert rep["worst_identity"] < 0.9


def test_parallel_validation_identical(monkeypatch):
    """n_jobs > 1 must be bit-identical to serial (exact integer costs).
    TELOMERI_FORCE_FORK exercises the real pool even under pytest's jax
    process (align.py _fork_unsafe would otherwise fall back to serial)."""
    monkeypatch.setenv("TELOMERI_FORCE_FORK", "1")
    g = _rand_seq(150_000, 24)
    s = _indel_mutate(g, 25, sub=0.02, ins=0.005, dele=0.005)
    scaffolds = SequenceSet(["s"], [s])
    genomes = SequenceSet(["g"], [g])
    r1 = validate_assembly(scaffolds, genomes)
    r2 = validate_assembly(scaffolds, genomes, n_jobs=2)
    assert r1 == r2


def test_reverse_strand_junction_window():
    """Junction coords are forward-scaffold; a reverse-strand placement must
    mirror the window (round-3 fix: the window was read from the wrong end)."""
    g = _rand_seq(60_000, 26)
    s_fwd = np.concatenate([g[0:30_000], g[45_000:55_000]])  # misjoin at 30k
    s = reverse_complement(s_fwd)
    rep = validate_assembly(SequenceSet(["s"], [s]), SequenceSet(["g"], [g]),
                            junctions={"s": [len(s) - 30_000]})
    assert rep["placements"][0]["strand"] == -1
    assert rep["worst_junction_identity"] < 0.6


def test_sampled_rate_unpolluted_by_junction_windows():
    """Junction windows sit over gap fills with far-above-average error; the
    sampled-mode rest-rate must come from the systematic sample EXCLUDING the
    window-forced segments, or whole-scaffold identity biases low (measured
    0.5% of identity at hg002 scale — round 3)."""
    g = _rand_seq(400_000, 31)
    # scaffold: clean copy except a 6 kb high-error patch around the "junction"
    s = np.concatenate([
        g[:197_000],
        _indel_mutate(g[197_000:203_000], 32, sub=0.06, ins=0.01, dele=0.01),
        g[203_000:]])
    scaffolds = SequenceSet(["s"], [s])
    genomes = SequenceSet(["g"], [g])
    full = validate_assembly(scaffolds, genomes, junctions={"s": [200_000]})
    samp = validate_assembly(scaffolds, genomes, junctions={"s": [200_000]},
                             sample=8)
    # the high-error patch is ~1.5% of columns at ~8% error: whole-scaffold
    # identity ~0.9988. A rate polluted by the exact junction windows would
    # overshoot the remaining edits several-fold.
    assert abs(samp["mean_identity"] - full["mean_identity"]) < 3e-4, \
        (samp["mean_identity"], full["mean_identity"])
    # junction identity itself is exact in both modes
    assert samp["worst_junction_identity"] == full["worst_junction_identity"]


def test_multi_reference_reverse_strand_with_decoy():
    """Round-3 review: strand order must come from the unique-hit probe. A
    scaffold truly from reference B's REVERSE strand, while reference A shares
    a weak forward-strand similarity (shared segment), must still place on
    B/-1 — a fixed +-first order with the >= 0.5 early break would stop at the
    decoy and never align B's mirror."""
    shared = _rand_seq(12_000, 41)
    a_rest = _rand_seq(28_000, 42)
    b_rest = _rand_seq(28_000, 43)
    ga = np.concatenate([shared, a_rest])
    gb = np.concatenate([shared, b_rest])
    s = reverse_complement(gb)            # true placement: gb, strand -1
    rep = validate_assembly(SequenceSet(["s"], [s]),
                            SequenceSet(["ga", "gb"], [ga, gb]))
    p = rep["placements"][0]
    assert (p["genome"], p["strand"]) == ("gb", -1), p
    assert p["identity"] == 1.0


def test_index_cache_roundtrip(tmp_path):
    """The persisted reference index must reproduce lookups exactly, hit on an
    unchanged genome, and miss (rebuild) when the genome changes."""
    g = _rand_seq(120_000, 51)
    s = _indel_mutate(g, 52, sub=0.01, ins=0.003, dele=0.003)
    scaffolds = SequenceSet(["s"], [s])
    genomes = SequenceSet(["g"], [g])
    r0 = validate_assembly(scaffolds, genomes)
    r1 = validate_assembly(scaffolds, genomes, index_cache_dir=str(tmp_path))
    # per-part fingerprints (round 5: resumable build — each array validates
    # independently; the legacy single fp is still honored for reading)
    assert (tmp_path / "g.k24.idx.sorted_km.fp.npy").exists()
    assert (tmp_path / "g.k24.idx.raw.fp.npy").exists()
    assert (tmp_path / "g.k24.idx.sorted_km.npy").exists()
    r2 = validate_assembly(scaffolds, genomes, index_cache_dir=str(tmp_path))
    assert r0 == r1 == r2                      # cold == build+save == mmap hit
    # the hit really memory-maps (np.load(mmap_mode) is a no-op on .npz — the
    # round-3 cache loaded eagerly; advisor r3 item 3)
    from telomeri_tpu.utils.validate import _cached_index

    idx = _cached_index(g, 24, str(tmp_path / "g.k24.idx"))
    assert isinstance(idx.sorted_km, np.memmap)
    # changed genome: fingerprint mismatch -> rebuild, correct placement
    g2 = g.copy()
    g2[:64] = ord("A")
    r3 = validate_assembly(SequenceSet(["s"], [g2[500:2500].copy()]),
                           SequenceSet(["g"], [g2]),
                           index_cache_dir=str(tmp_path))
    assert r3["placements"][0]["offset"] == 500


def test_index_cache_resumes_per_phase(tmp_path, monkeypatch):
    """VERDICT r4 weak 6: the genome-scale build is resumable at phase
    granularity. With the sort already on disk, a rebuild must NOT re-sort
    (only re-pack raw); with only raw on disk, it must NOT re-pack."""
    import telomeri_tpu.utils.validate as V
    from telomeri_tpu.utils.align import KmerIndex
    from telomeri_tpu.utils.validate import _cached_index

    g = _rand_seq(50_000, 3)
    stem = str(tmp_path / "x.idx")
    full = _cached_index(g, 24, stem)

    # sorted ok, raw missing -> the sort must be reused (from_packed forbidden)
    os.remove(stem + ".raw.fp.npy")
    monkeypatch.setattr(KmerIndex, "from_packed",
                        staticmethod(lambda *a, **k: (_ for _ in ()).throw(
                            AssertionError("re-sorted despite valid sort"))))
    idx = _cached_index(g, 24, stem)
    monkeypatch.undo()
    np.testing.assert_array_equal(np.asarray(idx.raw), np.asarray(full.raw))
    assert os.path.exists(stem + ".raw.fp.npy")   # raw re-persisted

    # raw ok, sorted missing -> the pack must be reused (pack_kmers forbidden)
    os.remove(stem + ".sorted_km.fp.npy")
    os.remove(stem + ".sorted_pos.fp.npy")
    monkeypatch.setattr(V, "pack_kmers",
                        lambda *a, **k: (_ for _ in ()).throw(
                            AssertionError("re-packed despite valid raw")))
    idx2 = _cached_index(g, 24, stem)
    monkeypatch.undo()
    np.testing.assert_array_equal(np.asarray(idx2.sorted_km),
                                  np.asarray(full.sorted_km))
    np.testing.assert_array_equal(np.asarray(idx2.sorted_pos),
                                  np.asarray(full.sorted_pos))
    assert os.path.exists(stem + ".sorted_km.fp.npy")


def test_adopt_index_tool(tmp_path):
    """tools/adopt_index.py: orphaned sorted arrays (fingerprint lost — the
    round-4 3 Gb failure mode) verify against the genome and get stamped; a
    corrupted array refuses adoption."""
    import subprocess
    import sys as _sys

    from telomeri_tpu.io.fasta import write_fasta
    from telomeri_tpu.utils.validate import _cached_index

    g = _rand_seq(60_000, 7)
    stem = str(tmp_path / "genome.k24.idx")
    _cached_index(g, 24, stem)
    for p in ("sorted_km", "sorted_pos", "raw"):
        os.remove(f"{stem}.{p}.fp.npy")           # simulate the lost-fp state
    os.remove(stem + ".raw.npy")
    fa = str(tmp_path / "genome.fa")
    write_fasta(fa, ["genome"], [g])
    tool = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "adopt_index.py")
    r = subprocess.run([_sys.executable, tool, fa, stem, "--samples", "5000"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.exists(stem + ".sorted_km.fp.npy")
    idx = _cached_index(g, 24, stem)              # warm hit + raw rebuild
    fresh = _cached_index(g, 24, None)
    np.testing.assert_array_equal(np.asarray(idx.sorted_km),
                                  np.asarray(fresh.sorted_km))
    # corrupted sort must refuse adoption
    km = np.load(stem + ".sorted_km.npy")
    km[::10] += 12345            # 10% corrupted: the content sample must hit
    np.save(stem + ".sorted_km.npy", km)
    os.remove(stem + ".sorted_km.fp.npy")
    r2 = subprocess.run([_sys.executable, tool, fa, stem, "--samples", "5000"],
                        capture_output=True, text=True)
    assert r2.returncode != 0


def test_low_memory_mode_identical_results(monkeypatch):
    """Round 5: at genome scale the raw k-mer pack is not held in RAM
    (page-cache thrash; _want_raw). raw is a perf-only slice cache, so
    results must be IDENTICAL with and without it."""
    import telomeri_tpu.utils.validate as V

    g = _rand_seq(150_000, 31)
    s = _indel_mutate(g, 32, sub=0.02, ins=0.01, dele=0.01)
    scaffolds = SequenceSet(["s"], [s])
    genomes = SequenceSet(["g"], [g])
    full = validate_assembly(scaffolds, genomes, junctions={"s": [70_000]})
    monkeypatch.setattr(V, "_want_raw", lambda arr: False)
    lean = validate_assembly(scaffolds, genomes, junctions={"s": [70_000]})
    assert full == lean


def test_index_cache_sum_preserving_edit_misses(tmp_path):
    """Advisor r3 item 2: a sum-preserving edit (swapping two bases) must
    invalidate the cache — crc32 catches what the old byte-sum missed."""
    from telomeri_tpu.utils.validate import _cached_index

    g = _rand_seq(50_000, 9)
    stem = str(tmp_path / "x.idx")
    _cached_index(g, 24, stem)
    g2 = g.copy()
    # swap two different adjacent bases: length and byte sum unchanged
    i = int(np.flatnonzero(g2[:-1] != g2[1:])[0])
    g2[i], g2[i + 1] = g2[i + 1], g2[i]
    idx2 = _cached_index(g2, 24, stem)
    fresh = _cached_index(g2, 24, None)
    np.testing.assert_array_equal(np.asarray(idx2.sorted_km),
                                  np.asarray(fresh.sorted_km))
    np.testing.assert_array_equal(np.asarray(idx2.sorted_pos),
                                  np.asarray(fresh.sorted_pos))
