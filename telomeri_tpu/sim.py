"""Synthetic scaffolding data simulator (SURVEY.md §3 row 17 "test data").

Generates, from a known ground-truth genome with exact-copy repeats:
  - draft contigs  = the unique regions between repeat copies (assembly breaks at repeats),
  - long reads     = error-injected substrings with random strand,
  - PAF overlaps   = computed from the known layout (coordinates are truth up to the
    optional end_jitter trim; nmatch/blocklen are alignment-accurate event counts),
so the pipeline can be validated end-to-end without minimap2 (the container has no network
egress and no aligner — SURVEY.md §0). This plays the role of the reference's E. coli test
data (BASELINE.md config #1/#2) at configurable scale.

Error model (round-2: the reference's real inputs are PacBio/ONT reads, which carry
INDELS, not just substitutions — VERDICT round 1 item 1):
  - substitutions with prob `error_rate` (always to a DIFFERENT base),
  - single-base deletions with prob `del_rate`,
  - single-base insertions after a position with prob `ins_rate`.
Every read keeps an exact genome<->read coordinate map (sparse event lists, see
ReadMap), so PAF rows carry the TRUE alignment endpoints in each sequence's own
frame — lengths of the two aligned spans differ when indels are present, exactly as
in minimap2 output. `end_jitter > 0` additionally trims each alignment end inward by
a uniform 0..end_jitter bases (minimap2 endpoints are alignment-local, not
truth-exact), keeping q/t coordinates mutually consistent.

Coordinate conventions match minimap2 PAF: qstart/qend are in the query's own forward
frame, tstart/tend in the target's forward frame, strand '-' means query maps to the
target's reverse complement. nmatch counts exactly-matching columns (event-derived:
a column matches unless either sequence deleted or substituted it); blocklen adds
inserted columns to the genome span.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from telomeri_tpu.io.fasta import reverse_complement

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class SimConfig:
    genome_len: int = 60_000
    repeat_len: int = 3_000
    n_repeat_copies: int = 2       # tandem-free exact copies, evenly spaced
    read_len_mean: int = 2_500     # genome span of a read (read length differs with indels)
    read_len_sd: int = 400
    read_min_len: int = 500
    coverage: float = 20.0
    error_rate: float = 0.02       # substitution rate
    ins_rate: float = 0.0          # single-base insertion rate (after a genome position)
    del_rate: float = 0.0          # single-base deletion rate
    end_jitter: int = 0            # max inward trim per PAF alignment end (bp)
    min_sim_overlap: int = 150     # emit PAF rows only for true overlaps >= this many bp
    # Cross-copy repeat overlaps: reads inside DIFFERENT copies of the exact
    # repeat genuinely align to each other, so a real aligner emits rows between
    # them — the source of (a) repeat-read degree skew (degree ~ copies x
    # coverage) and (b) the wrong-copy ambiguity HERA's length-consensus must
    # resolve. Off by default (round-1-compatible toy datasets); ON in the
    # genome-scale presets.
    cross_copy_overlaps: bool = False
    max_cross_rows: int = 2_000_000  # deterministic subsample cap on cross rows
    # Per-copy mutation rate: each planted copy diverges from the master repeat
    # (pairwise copy divergence ~ 2x this rate). Real genomic repeat copies are
    # 1-3% diverged — which is exactly what lets cross-copy alignments score
    # LOWER than same-copy ones and lets HERA-style consensus reject wrong-copy
    # bridges. With 0.0 (byte-identical copies) AND cross_copy_overlaps=True and
    # reads shorter than the repeat, wrong-copy pairings are
    # information-theoretically indistinguishable (same lengths, same scores) —
    # no scaffolder could resolve them; don't simulate that combination
    # expecting success.
    copy_divergence: float = 0.0
    # Chimeric (split) reads: with this FRACTION of extra reads, a read is the
    # concatenation of two error-injected segments from DISJOINT genome loci —
    # a library-prep artifact every real PacBio/ONT dataset contains. A real
    # aligner emits one PAF row per segment (same query name, disjoint query
    # intervals, unrelated targets): the classic misjoin bait for scaffolders
    # (VERDICT r2 item 5). 0.0 = off (byte-identical streams to round-2 sim).
    chimera_rate: float = 0.0
    # Coverage dropouts: n intervals of dropout_len bp with NO reads (any read
    # intersecting one is discarded, like an unclonable/unsequencable region).
    # A dropout spanning a repeat junction makes that gap honestly unbridgeable
    # — correct behavior is to LEAVE it unbridged, not invent a join.
    n_dropouts: int = 0
    dropout_len: int = 0
    # explicit dropout starts (tests aim one at a specific repeat junction);
    # empty = place n_dropouts uniformly at random
    dropout_starts: tuple = ()
    # Inverted repeat copies (round 4, VERDICT r3 missing #4): copy indices
    # planted as the REVERSE COMPLEMENT of the master repeat. Real genomes are
    # full of inverted repeats; a read inside an inverted copy aligns to a
    # normal-copy read on the OPPOSITE relative strand, so cross-copy rows
    # flip strand and mirror their repeat-local coordinates — the main
    # orientation symmetry of the oriented-node graph design that
    # same-orientation simulations never exercise.
    inverted_copies: tuple = ()
    # Tandem copy pairs: this many ADJACENT copy pairs — each pair planted
    # back-to-back as one 2*repeat_len block with NO unique sequence between
    # them (so no contig exists there; the scaffolder must bridge a
    # double-length repeat). Remaining copies stay isolated blocks.
    tandem_pairs: int = 0
    # Heterozygous SNP bubbles: rate of het sites planted in UNIQUE (non-
    # repeat) regions; every read is drawn from haplotype 0 or 1 at random.
    # Contigs/ground truth are haplotype 0, so alignments between opposite-
    # haplotype reads (and hap-1 reads vs contigs) carry extra mismatch
    # columns at het sites — the bubble noise a real diploid dataset has.
    het_rate: float = 0.0
    seed: int = 0


# Simulated stand-ins for the reference's evaluation configs (BASELINE.md; real data
# is unreachable in this zero-egress container — SURVEY.md §0). Scale knobs follow the
# real datasets' genome size / read profile, not their biology. Round 2: the genome-scale
# presets carry PacBio/ONT-like indel rates + endpoint jitter (VERDICT item 1).
PRESETS: dict[str, SimConfig] = {
    # BASELINE config #1: lambda-phage toy (checked in as testdata/lambda;
    # substitution-only + exact coordinates so the byte-golden stays stable)
    "lambda": SimConfig(genome_len=48_500, repeat_len=2_500, n_repeat_copies=2,
                        read_len_mean=2_000, read_len_sd=300, coverage=14.0,
                        error_rate=0.02, seed=77),
    # BASELINE config #2: E. coli K-12 scale, PacBio-ish reads (~7% total error,
    # indel-dominated, jittered endpoints)
    "ecoli": SimConfig(genome_len=4_600_000, repeat_len=5_000, n_repeat_copies=24,
                       read_len_mean=8_000, read_len_sd=2_000, read_min_len=1_000,
                       coverage=20.0, error_rate=0.02, ins_rate=0.025,
                       del_rate=0.025, end_jitter=25, min_sim_overlap=500, cross_copy_overlaps=True,
                       copy_divergence=0.02, seed=101),
    # BASELINE config #3: C. elegans chromosome scale (one ~15 Mb chromosome),
    # ONT-ish reads, repeat-dense
    "celegans-chr": SimConfig(genome_len=15_000_000, repeat_len=8_000,
                              n_repeat_copies=60, read_len_mean=15_000,
                              read_len_sd=6_000, read_min_len=2_000, coverage=15.0,
                              error_rate=0.03, ins_rate=0.02, del_rate=0.03,
                              end_jitter=40, min_sim_overlap=1_000, cross_copy_overlaps=True,
                              copy_divergence=0.02, seed=202),
    # BASELINE config #4: human chr21 scale, ultra-long ONT reads
    "chr21": SimConfig(genome_len=46_000_000, repeat_len=12_000, n_repeat_copies=120,
                       read_len_mean=40_000, read_len_sd=20_000, read_min_len=5_000,
                       coverage=12.0, error_rate=0.03, ins_rate=0.02, del_rate=0.03,
                       end_jitter=40, min_sim_overlap=2_000, cross_copy_overlaps=True,
                       copy_divergence=0.02, seed=303),
    # BASELINE config #5 (scaled): HG002-class whole-genome run at 1/10 genome size;
    # exercises lazy mmap ingest + artifacts + sectioned walks at a few-hundred-Mb
    # scale (SURVEY.md §8 PR7). Full-size inputs do not fit this container's disk.
    "hg002-sub": SimConfig(genome_len=300_000_000, repeat_len=15_000,
                           n_repeat_copies=400, read_len_mean=30_000,
                           read_len_sd=12_000, read_min_len=5_000, coverage=10.0,
                           error_rate=0.03, ins_rate=0.02, del_rate=0.03,
                           end_jitter=40, min_sim_overlap=2_000, cross_copy_overlaps=True,
                           copy_divergence=0.02, seed=404),
    # BASELINE config #5 at FULL scale (3 Gb, ~1M reads, ~30 GB of sequence):
    # feasible since the round-4 simulator scaling work (searchsorted contig/
    # copy probing + sampled cross-copy pair enumeration — the full-scan paths
    # were O(units x copies) and O(copy_pairs x touch^2)). Needs ~90 GB RAM
    # and ~40 GB disk; the replicated graph fits one card's device memory
    # (docs/ARCHITECTURE.md memory budget).
    "hg002": SimConfig(genome_len=3_000_000_000, repeat_len=15_000,
                       n_repeat_copies=4_000, read_len_mean=30_000,
                       read_len_sd=12_000, read_min_len=5_000, coverage=10.0,
                       error_rate=0.03, ins_rate=0.02, del_rate=0.03,
                       end_jitter=40, min_sim_overlap=2_000,
                       cross_copy_overlaps=True, copy_divergence=0.02,
                       seed=505),
}


@dataclass
class ReadMap:
    """Exact genome<->read coordinate map of one simulated read (sparse events).

    The read covers genome interval [a, b) on `strand`. Events are stored at
    GENOME positions, sorted:
      - ev_pos/ev_cum: positions whose emission count != 1 (deleted without
        insertion -> 0, kept with insertion -> 2, deleted with insertion -> 1 =
        no event); ev_cum[i] = cumulative (emission - 1) through event i.
      - bad: positions whose read base does not match the genome (substituted or
        deleted) — mismatch columns against an error-free sequence.
      - ins: positions followed by an inserted base (extra column in alignments).
    """

    a: int
    b: int
    strand: int
    length: int                # actual read length in bases
    ev_pos: np.ndarray
    ev_cum: np.ndarray
    bad: np.ndarray
    ins: np.ndarray

    def r(self, x) -> int:
        """Genome position x in [a, b] -> read offset in the read's genome-forward
        frame (number of read bases emitted for genome positions [a, x))."""
        i = int(np.searchsorted(self.ev_pos, x))
        return int(x - self.a + (self.ev_cum[i - 1] if i else 0))

    def local(self, x: int, y: int) -> tuple[int, int]:
        """Genome interval [x, y) -> (start, end) in the read's OWN forward frame
        (PAF query coordinates)."""
        qs, qe = self.r(x), self.r(y)
        if self.strand:
            return self.length - qe, self.length - qs
        return qs, qe

    def count_bad(self, x: int, y: int) -> int:
        lo, hi = np.searchsorted(self.bad, (x, y))
        return int(hi - lo)

    def count_ins(self, x: int, y: int) -> int:
        lo, hi = np.searchsorted(self.ins, (x, y))
        return int(hi - lo)


@dataclass
class AlignUnit:
    """One contiguously-mapping piece of a read (normal reads: exactly one;
    chimeric reads: one per segment). PAF rows are emitted per unit; query
    coordinates are q_off + the segment-local offset, in the read's forward
    frame (matching how minimap2 reports a split read: same query name and
    length, disjoint query intervals)."""

    read: int        # index into reads/read_names
    q_off: int       # segment start in the read's forward frame
    q_len: int       # FULL read length (PAF column 2)
    rmap: ReadMap    # segment genome interval / strand / coordinate map
    hap: int = 0     # haplotype the read was drawn from (het_rate > 0)


@dataclass
class SimData:
    genome: np.ndarray                    # uint8 ground truth
    contig_names: list[str]
    contigs: list[np.ndarray]
    contig_pos: list[tuple[int, int]]     # genome interval of each contig
    read_names: list[str]
    reads: list[np.ndarray]
    read_pos: list[tuple[int, int, int]]  # (start, end, strand) on genome
    read_maps: list[ReadMap] = field(default_factory=list)
    units: list[AlignUnit] = field(default_factory=list)
    chimeric: list[int] = field(default_factory=list)   # read indices
    dropouts: list[tuple[int, int]] = field(default_factory=list)
    het_pos: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    paf_read_contig: list[str] = field(default_factory=list)  # PAF text lines
    paf_read_read: list[str] = field(default_factory=list)


def _make_read(genome: np.ndarray, a: int, b: int, strand: int,
               cfg: SimConfig, rng: np.random.Generator) -> tuple[np.ndarray, ReadMap]:
    """Error-injected read over genome[a:b) + its exact coordinate map.

    RNG draw order (sub, then del/ins only when their rates are nonzero) keeps the
    default substitution-only stream identical to the round-1 simulator."""
    n = b - a
    gseg = genome[a:b]
    sub = rng.random(n) < cfg.error_rate
    deleted = (rng.random(n) < cfg.del_rate) if cfg.del_rate > 0 else np.zeros(n, bool)
    ins = (rng.random(n) < cfg.ins_rate) if cfg.ins_rate > 0 else np.zeros(n, bool)
    sub &= ~deleted

    kept = ~deleted
    emit = kept.astype(np.int64) + ins
    starts = np.cumsum(emit) - emit        # read offset emitted for each genome pos
    rlen = int(starts[-1] + emit[-1]) if n else 0

    seq = np.empty(rlen, np.uint8)
    kept_pos = np.flatnonzero(kept)
    seq[starts[kept_pos]] = gseg[kept_pos]
    sub_pos = np.flatnonzero(sub)
    if sub_pos.size:
        # substitute with a DIFFERENT base: add 1..3 mod 4 in base space
        cur = np.searchsorted(BASES, gseg[sub_pos])  # BASES is sorted (A<C<G<T)
        seq[starts[sub_pos]] = BASES[(cur + rng.integers(1, 4, len(sub_pos))) % 4]
    ins_pos = np.flatnonzero(ins)
    if ins_pos.size:
        seq[starts[ins_pos] + kept[ins_pos]] = BASES[rng.integers(0, 4, len(ins_pos))]

    ev = np.flatnonzero(emit != 1)
    rmap = ReadMap(
        a=a, b=b, strand=strand, length=rlen,
        ev_pos=(ev + a).astype(np.int64),
        ev_cum=np.cumsum(emit[ev] - 1).astype(np.int64),
        bad=(np.flatnonzero(sub | deleted) + a).astype(np.int64),
        ins=(ins_pos + a).astype(np.int64),
    )
    if strand == 1:
        seq = reverse_complement(seq)
    return seq, rmap


def simulate(cfg: SimConfig) -> SimData:
    rng = np.random.default_rng(cfg.seed)
    genome = BASES[rng.integers(0, 4, cfg.genome_len)]

    # Plant exact repeat copies, grouped into BLOCKS: the first tandem_pairs
    # blocks hold two back-to-back copies (no unique sequence between them),
    # the rest one copy each. Blocks are evenly spaced away from the genome
    # ends. With tandem_pairs=0 this reduces exactly to the round-3 layout
    # (same gap formula, same starts, same RNG stream).
    repeat = BASES[rng.integers(0, 4, cfg.repeat_len)]
    L = cfg.repeat_len
    n_cop = cfg.n_repeat_copies
    if 2 * cfg.tandem_pairs > n_cop:
        raise ValueError(
            f"tandem_pairs={cfg.tandem_pairs} needs >= {2 * cfg.tandem_pairs} "
            f"repeat copies, have {n_cop}")
    inv = {int(i) for i in cfg.inverted_copies}
    if inv and not inv <= set(range(n_cop)):
        raise ValueError(f"inverted_copies {sorted(inv)} out of range 0..{n_cop - 1}")
    copies_per_block = [2] * cfg.tandem_pairs + [1] * (n_cop - 2 * cfg.tandem_pairs)
    n_blocks = len(copies_per_block)
    gap = (cfg.genome_len - n_cop * L) // (n_blocks + 1)
    if gap <= cfg.read_len_mean:
        raise ValueError(
            f"genome too small: unique gap {gap} <= mean read length "
            f"{cfg.read_len_mean}; increase genome_len or reduce copies")
    starts: list[int] = []
    cut = [0]
    pos = 0
    for ncb in copies_per_block:
        pos += gap
        cut += [pos, pos + ncb * L]
        for c in range(ncb):
            starts.append(pos + c * L)
        pos += ncb * L
    cut.append(cfg.genome_len)
    mut_sites: list[np.ndarray] = []   # MASTER-local divergence sites per copy
    for ci, s in enumerate(starts):
        copy = repeat
        if cfg.copy_divergence > 0:
            copy = repeat.copy()
            pos_m = np.flatnonzero(rng.random(L) < cfg.copy_divergence / 2)
            if pos_m.size:
                cur = np.searchsorted(BASES, copy[pos_m])
                copy[pos_m] = BASES[(cur + rng.integers(1, 4, len(pos_m))) % 4]
            mut_sites.append(pos_m.astype(np.int64))
        else:
            mut_sites.append(np.empty(0, np.int64))
        # inverted copies are planted as RC of the (diverged) master; divergence
        # sites stay master-local, so cross-copy accounting is orientation-free
        genome[s : s + L] = reverse_complement(copy) if ci in inv else copy

    # Contigs: unique regions between repeat BLOCKS (assembly breaks at each
    # block; a tandem block contributes no interior contig).
    contig_pos = [(cut[2 * i], cut[2 * i + 1]) for i in range(n_blocks + 1)]
    contigs = [genome[a:b].copy() for a, b in contig_pos]
    contig_names = [f"ctg{i:03d}" for i in range(len(contigs))]

    # Heterozygous SNP bubbles: het sites in unique regions only (het inside a
    # repeat would entangle with cross-copy divergence accounting); haplotype 0
    # IS the ground-truth genome/contigs, haplotype 1 differs at het_pos.
    het_pos = np.empty(0, np.int64)
    genome_alt = None
    if cfg.het_rate > 0:
        uniq = np.ones(cfg.genome_len, bool)
        for s in starts:
            uniq[s : s + L] = False
        cand = np.flatnonzero(uniq)
        het_pos = cand[rng.random(len(cand)) < cfg.het_rate].astype(np.int64)
        genome_alt = genome.copy()
        if het_pos.size:
            cur = np.searchsorted(BASES, genome_alt[het_pos])
            genome_alt[het_pos] = BASES[(cur + rng.integers(1, 4, len(het_pos))) % 4]

    # Reads: uniform starts, normal genome spans, random strand, injected errors.
    n_reads = int(cfg.coverage * cfg.genome_len / cfg.read_len_mean)
    lens = np.clip(
        rng.normal(cfg.read_len_mean, cfg.read_len_sd, n_reads).astype(np.int64),
        cfg.read_min_len, cfg.genome_len,
    )
    starts_r = rng.integers(0, np.maximum(cfg.genome_len - lens, 1))
    strands = rng.integers(0, 2, n_reads)
    # haplotype per read (draw gated so het_rate=0 keeps the stream identical)
    haps = rng.integers(0, 2, n_reads) if cfg.het_rate > 0 else np.zeros(n_reads, np.int64)
    hap_genome = (genome, genome_alt if genome_alt is not None else genome)
    reads, read_pos, read_names, read_maps = [], [], [], []
    units: list[AlignUnit] = []
    for i in range(n_reads):
        a = int(starts_r[i])
        b = min(a + int(lens[i]), cfg.genome_len)
        seq, rmap = _make_read(hap_genome[int(haps[i])], a, b, int(strands[i]),
                               cfg, rng)
        reads.append(seq)
        read_maps.append(rmap)
        read_pos.append((a, b, int(strands[i])))
        read_names.append(f"read{i:05d}")
        units.append(AlignUnit(read=i, q_off=0, q_len=rmap.length, rmap=rmap,
                               hap=int(haps[i])))

    # Chimeric reads: two disjoint-locus segments concatenated (knob doc above).
    # Drawn AFTER the normal reads so chimera_rate=0 keeps every earlier stream
    # byte-identical (same gating idea as del/ins in _make_read).
    chimeric: list[int] = []
    if cfg.chimera_rate > 0:
        n_chim = max(1, int(round(cfg.chimera_rate * n_reads)))
        half = max(cfg.read_len_mean // 2, cfg.read_min_len)
        for t in range(n_chim):
            spans = np.clip(
                rng.normal(half, max(cfg.read_len_sd // 2, 1), 2).astype(np.int64),
                cfg.read_min_len, cfg.genome_len // 4)
            sa, sb = int(spans[0]), int(spans[1])
            for _try in range(64):
                a1 = int(rng.integers(0, max(cfg.genome_len - sa, 1)))
                a2 = int(rng.integers(0, max(cfg.genome_len - sb, 1)))
                if min(a1 + sa, a2 + sb) + cfg.min_sim_overlap < max(a1, a2):
                    break   # disjoint loci (with margin): a real split artifact
            else:
                # genome too small for disjoint segments of these spans: skip
                # rather than emit a "chimera" whose halves co-locate (review
                # r3 — a locally-consistent read must not be labeled chimeric)
                continue
            st1, st2 = int(rng.integers(0, 2)), int(rng.integers(0, 2))
            hap = int(rng.integers(0, 2)) if cfg.het_rate > 0 else 0
            idx = len(reads)
            seq1, map1 = _make_read(hap_genome[hap], a1, a1 + sa, st1, cfg, rng)
            seq2, map2 = _make_read(hap_genome[hap], a2, a2 + sb, st2, cfg, rng)
            full = np.concatenate([seq1, seq2])
            reads.append(full)
            read_names.append(f"read{idx:05d}")
            # read_pos/read_maps keep ONE entry per read (segment 1) for the
            # legacy per-read views; PAF emission iterates `units`, which carry
            # both segments with their query offsets in the read-forward frame
            read_pos.append((a1, a1 + sa, st1))
            read_maps.append(map1)
            units.append(AlignUnit(read=idx, q_off=0, q_len=len(full), rmap=map1,
                                   hap=hap))
            units.append(AlignUnit(read=idx, q_off=map1.length, q_len=len(full),
                                   rmap=map2, hap=hap))
            chimeric.append(idx)

    # Coverage dropouts: discard any read with a segment intersecting one.
    dropouts: list[tuple[int, int]] = []
    if (cfg.n_dropouts > 0 or cfg.dropout_starts) and cfg.dropout_len > 0:
        if cfg.dropout_starts:
            dropouts = [(int(s), int(s) + cfg.dropout_len)
                        for s in cfg.dropout_starts]
        else:
            for _ in range(cfg.n_dropouts):
                s = int(rng.integers(0, max(cfg.genome_len - cfg.dropout_len, 1)))
                dropouts.append((s, s + cfg.dropout_len))
        dead = set()
        for u in units:
            if any(u.rmap.a < e and s < u.rmap.b for s, e in dropouts):
                dead.add(u.read)
        keep = [i for i in range(len(reads)) if i not in dead]
        remap = {old: new for new, old in enumerate(keep)}
        reads = [reads[i] for i in keep]
        read_names = [f"read{n:05d}" for n in range(len(keep))]
        read_pos = [read_pos[i] for i in keep]
        read_maps = [read_maps[i] for i in keep]
        units = [AlignUnit(read=remap[u.read], q_off=u.q_off, q_len=u.q_len,
                           rmap=u.rmap, hap=u.hap)
                 for u in units if u.read not in dead]
        chimeric = [remap[i] for i in chimeric if i not in dead]

    data = SimData(
        genome=genome, contig_names=contig_names, contigs=contigs,
        contig_pos=contig_pos, read_names=read_names, reads=reads,
        read_pos=read_pos, read_maps=read_maps, units=units,
        chimeric=chimeric, dropouts=dropouts, het_pos=het_pos,
    )
    data.paf_read_contig = _paf_read_vs_contigs(data, cfg, rng)
    data.paf_read_read = _paf_read_vs_read(data, cfg, rng)
    if cfg.cross_copy_overlaps:
        data.paf_read_read += _paf_cross_copy(data, cfg, rng, starts, mut_sites,
                                              inv)
    return data


def _jitter(x: int, y: int, cfg: SimConfig, rng: np.random.Generator) -> tuple[int, int]:
    """Trim the true overlap interval inward like minimap2's alignment-local
    endpoints. Coordinates derived from the trimmed interval stay mutually
    consistent between query and target (both map the same genome positions)."""
    if cfg.end_jitter <= 0:
        return x, y
    t1 = int(rng.integers(0, cfg.end_jitter + 1))
    t2 = int(rng.integers(0, cfg.end_jitter + 1))
    if (y - t2) - (x + t1) >= max(cfg.min_sim_overlap // 2, 32):
        return x + t1, y - t2
    return x, y


def _paf_row(qn, ql, qs, qe, strand, tn, tl, ts, te, nm, bl) -> str:
    return "\t".join(map(str, (qn, ql, qs, qe, "+-"[strand], tn, tl, ts, te, nm, bl, 255)))


def _paf_read_vs_contigs(d: SimData, cfg: SimConfig, rng: np.random.Generator) -> list[str]:
    rows = []
    c_starts = np.asarray([p[0] for p in d.contig_pos], np.int64)  # ascending
    c_ends = np.asarray([p[1] for p in d.contig_pos], np.int64)
    max_clen = int((c_ends - c_starts).max()) if len(c_starts) else 0
    for u in d.units:
        m = u.rmap
        ra, rb, rs = m.a, m.b, m.strand
        # a read overlaps O(1) contigs: probe the candidates via searchsorted
        # instead of scanning all contigs per unit (O(units x contigs) was
        # hours at genome scale)
        c0 = int(np.searchsorted(c_starts, ra - max_clen, side="right"))
        c1 = int(np.searchsorted(c_starts, rb, side="left"))
        for ci in range(max(c0 - 1, 0), c1):
            ca, cb = d.contig_pos[ci]
            x, y = max(ra, ca), min(rb, cb)
            if y - x < cfg.min_sim_overlap:
                continue
            x, y = _jitter(x, y, cfg, rng)
            # contigs are error-free HAPLOTYPE-0 genome slices: a column
            # mismatches iff the read substituted/deleted it, or (hap-1 reads)
            # sits on a het site; insertions add alignment columns
            if u.hap and d.het_pos.size:
                lo_b, hi_b = np.searchsorted(m.bad, (x, y))
                lo_h, hi_h = np.searchsorted(d.het_pos, (x, y))
                n_bad = np.union1d(m.bad[lo_b:hi_b],
                                   d.het_pos[lo_h:hi_h]).size
            else:
                n_bad = m.count_bad(x, y)
            nm = (y - x) - int(n_bad)
            bl = (y - x) + m.count_ins(x, y)
            qs, qe = m.local(x, y)
            rows.append(_paf_row(
                d.read_names[u.read], u.q_len, u.q_off + qs, u.q_off + qe, rs,
                d.contig_names[ci], cb - ca, x - ca, y - ca, nm, bl,
            ))
    return rows


def _paf_read_vs_read(d: SimData, cfg: SimConfig, rng: np.random.Generator) -> list[str]:
    """All true unit pairs overlapping by >= min_sim_overlap, via a sorted sweep.
    Units of the SAME chimeric read never pair with each other (an aligner does
    not report a read against itself)."""
    n = len(d.units)
    order = sorted(range(n), key=lambda i: d.units[i].rmap.a)
    rows = []
    active: list[int] = []
    for i in order:
        ui = d.units[i]
        mi = ui.rmap
        ra, rb, rs = mi.a, mi.b, mi.strand
        # sweep prune (units sorted by start; j stays active while it can still
        # overlap any later unit by >= min_sim_overlap)
        active = [j for j in active
                  if d.units[j].rmap.b >= ra + cfg.min_sim_overlap]
        for j in active:
            uj = d.units[j]
            if uj.read == ui.read:
                continue
            mj = uj.rmap
            x, y = max(ra, mj.a), min(rb, mj.b)
            if y - x < cfg.min_sim_overlap:
                continue
            x, y = _jitter(x, y, cfg, rng)
            # a column matches unless EITHER read substituted/deleted it (both
            # substituting to the same base is counted as mismatch — a <0.1%
            # undercount at real rates, consistent in spirit with an aligner's
            # conservative match count)
            lo_i, hi_i = np.searchsorted(mi.bad, (x, y))
            lo_j, hi_j = np.searchsorted(mj.bad, (x, y))
            bads = [mi.bad[lo_i:hi_i], mj.bad[lo_j:hi_j]]
            if ui.hap != uj.hap and d.het_pos.size:
                # opposite haplotypes also mismatch at every het site in the span
                lo_h, hi_h = np.searchsorted(d.het_pos, (x, y))
                bads.append(d.het_pos[lo_h:hi_h])
            n_bad = np.unique(np.concatenate(bads)).size
            nm = (y - x) - int(n_bad)
            bl = (y - x) + mi.count_ins(x, y) + mj.count_ins(x, y)
            qs, qe = mi.local(x, y)
            ts, te = mj.local(x, y)
            rows.append(_paf_row(
                d.read_names[ui.read], ui.q_len, ui.q_off + qs, ui.q_off + qe,
                rs ^ mj.strand,
                d.read_names[uj.read], uj.q_len, uj.q_off + ts, uj.q_off + te,
                nm, bl,
            ))
        active.append(i)
    return rows


def _paf_cross_copy(d: SimData, cfg: SimConfig, rng: np.random.Generator,
                    repeat_starts: list[int], mut_sites: list[np.ndarray],
                    inverted: set[int] = frozenset()) -> list[str]:
    """PAF rows between reads sitting in DIFFERENT copies of the exact repeat.

    Repeat copies are byte-identical, so the repeat-interior parts of two such
    reads genuinely align; a real aligner (minimap2) emits these rows, and they
    are what makes repeat graphs hard: repeat-read out-degree scales with
    copies x coverage, and the graph gains wrong-copy edges that only HERA's
    path-length consensus can reject.

    All interval math happens in MASTER-repeat coordinates: a normal copy maps
    genome [s+x, s+y) to master [x, y); an INVERTED copy (round 4) holds
    RC(master), so master [x, y) lives at genome [s+L-y, s+L-x) and a read's
    orientation relative to the master is its genome strand XOR the copy's
    inversion — cross rows between a normal-copy and an inverted-copy read
    come out strand-flipped with mirrored coordinates, exactly as minimap2
    reports them."""
    L = cfg.repeat_len
    touch: list[list[tuple[int, int, int]]] = [[] for _ in repeat_starts]
    starts_arr = np.asarray(repeat_starts, np.int64)   # built ascending
    for ui, u in enumerate(d.units):
        a, b = u.rmap.a, u.rmap.b
        # only copies with s in (a - L, b) can overlap the unit — a read spans
        # O(1) copies, so probe them via searchsorted instead of scanning all
        # n_cop copies per unit (O(units x copies) was hours at genome scale)
        c0 = int(np.searchsorted(starts_arr, a - L, side="right"))
        c1 = int(np.searchsorted(starts_arr, b, side="left"))
        for ci in range(c0, c1):
            s = int(starts_arr[ci])
            x, y = max(a, s), min(b, s + L)
            if y - x >= cfg.min_sim_overlap:
                lo, hi = x - s, y - s                  # planted-local interval
                if ci in inverted:
                    lo, hi = L - hi, L - lo            # -> master-local
                touch[ci].append((ui, lo, hi))
    n_cop = len(repeat_starts)
    # Candidate enumeration is O(copy_pairs x touch^2): fine at hundreds of
    # copies (hg002-sub: 8e4 copy pairs), hours at full genome scale (4,000
    # copies -> 8e6 copy pairs x ~600 unit pairs each). When the estimate
    # exceeds the row cap by 4x, SAMPLE copy pairs in a deterministic
    # rng-shuffled order and stop once enough candidates are collected — the
    # emitted rows are still a uniform-ish cross-copy subsample (real aligners
    # also emit only the best-scoring fraction of repeat self-similarity).
    t_sizes = np.array([len(t) for t in touch], dtype=np.int64)
    total_t = int(t_sizes.sum())
    est = (total_t * total_t - int((t_sizes * t_sizes).sum())) // 2
    budget = (4 * cfg.max_cross_rows) if cfg.max_cross_rows else est
    pairs: list[tuple[int, int, int, int, int, int]] = []
    if est > budget and n_cop >= 2:
        order = rng.permutation(n_cop * (n_cop - 1) // 2)
        # map a flat index to the (i, j) upper-triangle pair
        ii, jj = np.triu_indices(n_cop, k=1)
        for f in order:
            i, j = int(ii[f]), int(jj[f])
            for ui, lo1, hi1 in touch[i]:
                for uj, lo2, hi2 in touch[j]:
                    if d.units[ui].read == d.units[uj].read:
                        continue
                    x, y = max(lo1, lo2), min(hi1, hi2)
                    if y - x >= cfg.min_sim_overlap:
                        pairs.append((ui, i, uj, j, x, y))
            if len(pairs) >= budget:
                break
    else:
        for i in range(n_cop):
            for j in range(i + 1, n_cop):
                for ui, lo1, hi1 in touch[i]:
                    for uj, lo2, hi2 in touch[j]:
                        if d.units[ui].read == d.units[uj].read:
                            continue
                        x, y = max(lo1, lo2), min(hi1, hi2)
                        if y - x >= cfg.min_sim_overlap:
                            pairs.append((ui, i, uj, j, x, y))
    if cfg.max_cross_rows and len(pairs) > cfg.max_cross_rows:
        keep = rng.choice(len(pairs), cfg.max_cross_rows, replace=False)
        keep.sort()
        pairs = [pairs[t] for t in keep]
    rows = []
    for ui, ci, uj, cj, x, y in pairs:
        if cfg.end_jitter > 0:
            t1 = int(rng.integers(0, cfg.end_jitter + 1))
            t2 = int(rng.integers(0, cfg.end_jitter + 1))
            if (y - t2) - (x + t1) >= max(cfg.min_sim_overlap // 2, 32):
                x, y = x + t1, y - t2
        a, b = d.units[ui], d.units[uj]
        mi, mj = a.rmap, b.rmap

        def gwin(cix: int, mx: int, my: int) -> tuple[int, int]:
            """Master interval [mx, my) -> genome interval in copy cix."""
            s = repeat_starts[cix]
            if cix in inverted:
                return s + L - my, s + L - mx
            return s + mx, s + my
        gi = gwin(ci, x, y)
        gj = gwin(cj, x, y)
        # mismatch columns: copy-divergence sites where the two copies differ
        # (union of their MASTER-local mutation sites in the shared interval),
        # plus each read's own errors (disjoint genome ranges, counts add)
        lo_i, hi_i = np.searchsorted(mut_sites[ci], (x, y))
        lo_j, hi_j = np.searchsorted(mut_sites[cj], (x, y))
        n_div = np.union1d(mut_sites[ci][lo_i:hi_i], mut_sites[cj][lo_j:hi_j]).size
        nm = (y - x) - int(n_div) \
            - mi.count_bad(*gi) - mj.count_bad(*gj)
        bl = (y - x) + mi.count_ins(*gi) + mj.count_ins(*gj)
        qs, qe = mi.local(*gi)
        ts, te = mj.local(*gj)
        rows.append(_paf_row(
            d.read_names[a.read], a.q_len, a.q_off + qs, a.q_off + qe,
            (mi.strand ^ (ci in inverted)) ^ (mj.strand ^ (cj in inverted)),
            d.read_names[b.read], b.q_len, b.q_off + ts, b.q_off + te, nm, bl,
        ))
    return rows


def write_dataset(d: SimData, outdir: str) -> None:
    """Write contigs.fa, reads.fa, read2contig.paf, read2read.paf, genome.fa."""
    import os

    from telomeri_tpu.io.fasta import write_fasta

    os.makedirs(outdir, exist_ok=True)
    write_fasta(os.path.join(outdir, "contigs.fa"), d.contig_names, d.contigs)
    write_fasta(os.path.join(outdir, "reads.fa"), d.read_names, d.reads)
    write_fasta(os.path.join(outdir, "genome.fa"), ["genome"], [d.genome])
    for fn, rows in (("read2contig.paf", d.paf_read_contig),
                     ("read2read.paf", d.paf_read_read)):
        with open(os.path.join(outdir, fn), "w") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))
