"""Overlap geometry, filtering, and directed-edge construction (host, vectorized numpy).

Reference parity: the C++ reference's overlap filter + scoring at graph build (SURVEY.md §3
rows 4-5; mount empty, SURVEY.md §0 — formulas follow the HERA method, Du & Liang 2019).

Node encoding (the fixed-shape design of SURVEY.md §2.2 `graph/`): every sequence s gets TWO
oriented nodes, id = 2*s (forward) and 2*s+1 (reverse-complement). A directed edge u -> v
means "v, in its orientation, extends u rightward". Every kept PAF row yields exactly two
directed edges: e (left node -> right node) and its mirror rc(right) -> rc(left). Walks are
then orientation-free CSR traversals; an anchor END is simply an oriented anchor node
(2c = right end of contig c, 2c+1 = left end).

Geometry, with q in forward orientation and the target's coordinates flipped when
strand == '-' (ts' = tlen-tend, te' = tlen-tstart):

      lo_q = qs        ro_q = ql - qe          (q's unaligned left/right overhangs)
      lo_t = ts'       ro_t = tl - te'
      OL1  = qe - qs   OL2  = te' - ts'        (aligned spans)

The row is classified (config filter rules 1-6, see ScaffoldConfig docstring) and, if kept,
the LEFT node L is the one with the larger left overhang (tie -> q is left; documented
tie-break). With L=q, R=t:

      OH1 = ro_q (L's tail past the overlap)   OH2 = lo_t (R's head before the overlap)
      EL1 = lo_q - lo_t                        EL2 = ro_t - ro_q
      SI  = nmatch / blocklen
      OS  = SI * (OL1 + OL2) / 2
      ES2 = OS + EL2/2 - (OH1 + OH2)/2         (score of edge L+ -> R(s):  extend right)
      ES1 = OS + EL1/2 - (OH1 + OH2)/2         (score of mirror rc(R) -> rc(L))

Stitch coordinates stored per edge (see scaffold/stitch.py): ue = end of the aligned block
in the SOURCE node's oriented coordinates, ve = same for the DESTINATION node. Appending a
destination node to a growing scaffold places it at global offset  g_v = g_u + ue - ve  and
advances the scaffold end by  adv = ue + (len_v - ve) - len_u  (= EL2 for the forward edge,
EL1 for the mirror).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.io.paf import PafRecords


@dataclass
class EdgeSoA:
    """Directed overlap-graph edges as SoA (host numpy; shipped to HBM by graph/tensorize).

    All arrays share length n_edges. Node ids are oriented (2*seq + orient).
    """

    src: np.ndarray   # int32 oriented node id
    dst: np.ndarray   # int32 oriented node id
    os_: np.ndarray   # float32 overlap score
    es: np.ndarray    # float32 extension score in this edge's direction
    adv: np.ndarray   # int32 scaffold-end advance (bp) when traversing this edge
    ue: np.ndarray    # int32 aligned-block end in src oriented coords
    ve: np.ndarray    # int32 aligned-block end in dst oriented coords
    row: np.ndarray   # int32 originating PAF row index (diagnostics/round-trip)
    # raw geometry (int32), kept so devices can re-score edges with kernels/scoring.py:
    # es == OS + el/2 - (oh1+oh2)/2 with OS = (nm/bl) * (ol1+ol2)/2
    nm: np.ndarray = None
    bl: np.ndarray = None
    ol1: np.ndarray = None
    ol2: np.ndarray = None
    oh1: np.ndarray = None
    oh2: np.ndarray = None
    el: np.ndarray = None

    def __len__(self) -> int:
        return len(self.src)

    def geom_args(self):
        """Arguments for kernels.scoring.score_overlaps* (el passed as both EL1/EL2;
        the edge's own direction uses the es2 output)."""
        return (self.nm, self.bl, self.ol1, self.ol2, self.oh1, self.oh2,
                self.el, self.el)


@dataclass
class FilterStats:
    n_rows: int = 0
    n_malformed: int = 0
    n_self: int = 0
    n_low_identity: int = 0
    n_short: int = 0
    n_internal: int = 0
    n_contained: int = 0
    n_high_overhang: int = 0
    n_kept: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def malformed_mask(paf: PafRecords) -> np.ndarray:
    """Rule 0 (round 4, VERDICT r3 missing #3): internally inconsistent rows.

    An 11-column line can still carry arithmetic garbage — coordinates past
    sequence ends, inverted or zero-length blocks, nmatch > blocklen,
    non-positive lengths — which minimap2 never emits but corrupt files and
    adversarial inputs do. Such rows would flow NEGATIVE overhangs/overlaps
    into the rule 1-6 classification and score/stitch coordinates (e.g. a
    negative right-overhang inflates ES; a coordinate past the sequence end
    makes the stitcher slice out of range), so they are dropped FIRST under
    their own counter, before any geometry is trusted. All comparisons are on
    the RAW (unflipped) coordinates: minimap2 PAF coordinates are always
    original-strand, start < end."""
    return (
        (paf.qlen <= 0) | (paf.tlen <= 0)
        | (paf.qstart < 0) | (paf.tstart < 0)
        | (paf.qend <= paf.qstart) | (paf.tend <= paf.tstart)   # empty/inverted
        | (paf.qend > paf.qlen) | (paf.tend > paf.tlen)         # past the end
        | (paf.nmatch < 0) | (paf.blocklen <= 0)
        | (paf.nmatch > paf.blocklen)
    )


def overlap_geometry(paf: PafRecords) -> dict[str, np.ndarray]:
    """Orientation-corrected geometry for every PAF row (before filtering)."""
    strand = paf.strand.astype(np.int64)
    ts = np.where(strand == 1, paf.tlen - paf.tend, paf.tstart).astype(np.int64)
    te = np.where(strand == 1, paf.tlen - paf.tstart, paf.tend).astype(np.int64)
    qs, qe = paf.qstart.astype(np.int64), paf.qend.astype(np.int64)
    ql, tl = paf.qlen.astype(np.int64), paf.tlen.astype(np.int64)
    # SI in float32 with the exact op order of kernels/scoring.py, so the filter's
    # min_identity boundary behaves identically on host and device.
    si = paf.nmatch.astype(np.float32) / np.maximum(paf.blocklen, 1).astype(np.float32)
    return {
        "qs": qs, "qe": qe, "ql": ql, "ts": ts, "te": te, "tl": tl,
        "lo_q": qs, "ro_q": ql - qe, "lo_t": ts, "ro_t": tl - te,
        "ol1": qe - qs, "ol2": te - ts,
        "si": si,
    }


def split_evidence_mask(paf: PafRecords, min_identity: float) -> np.ndarray:
    """Rows eligible as junction-SPANNING evidence for split_mapped.

    An interval only disproves a breakpoint if it is a REAL alignment:
    malformed rows (rule 0) have untrustworthy coordinates; SELF rows (rule 1)
    span any breakpoint trivially (a read always matches itself — review r4:
    one self-hit row un-flagged a chimera and let its fabricated bridge
    through the clean-cut-read branch); sub-min_identity rows are noise that
    cannot certify homology across a junction. Rows dropped by the LATER
    graph-filter rules (containment, internal match, overhang) stay eligible:
    they are genuine alignments — a containing long read crossing the
    breakpoint is exactly the evidence that the junction is real."""
    si = paf.nmatch.astype(np.float32) / np.maximum(paf.blocklen, 1).astype(
        np.float32)
    return (~malformed_mask(paf) & (paf.qid != paf.tid)
            & (si >= np.float32(min_identity)))


def split_mapped(paf: PafRecords, n_seqs: int, min_overlap: int = 100,
                 row_mask: np.ndarray | None = None) -> np.ndarray:
    """(n_seqs,) bool: sequences whose PAF alignments carry a chimera-signature
    BREAKPOINT — an interior position no alignment spans.

    A chimeric (split) read is two concatenated segments from unrelated loci,
    so its alignments tile it in two clusters that MEET at the junction: left-
    cluster intervals end at ~p, right-cluster intervals start at ~p, and no
    single alignment crosses p (no other sequence contains that concatenation).
    A clean read's overlapping neighbours produce intervals that genuinely
    OVERLAP each other through every interior point. Detection: sweep each
    sequence's intervals (query AND target roles) in start order; a breakpoint
    exists where the next interval overlaps the running reach of all earlier
    intervals by FEWER than min_overlap bp, at an interior position (both
    sides have >= 2*min_overlap of mapped sequence). End-jitter trims are
    tens of bp, real overlap lengths hundreds-thousands, so min_overlap=100
    separates them; a clean read in a coverage dip can false-flag, which is
    conservative (its junction gets blocked, never misjoined).

    The cut-read gate (consensus/evidence.py) uses this to tell a clean
    single-spanning-read junction (accept) from a chimera-fabricated one
    (refuse) — round 3 refused BOTH as indistinguishable; the mapping geometry
    distinguishes them. row_mask selects the rows eligible as evidence
    (split_evidence_mask; defaults to excluding malformed + self rows)."""
    ok = (row_mask if row_mask is not None
          else (~malformed_mask(paf) & (paf.qid != paf.tid)))
    ids = np.concatenate([paf.qid[ok], paf.tid[ok]]).astype(np.int64)
    starts = np.concatenate([paf.qstart[ok], paf.tstart[ok]]).astype(np.int64)
    ends = np.concatenate([paf.qend[ok], paf.tend[ok]]).astype(np.int64)
    lens = np.concatenate([paf.qlen[ok], paf.tlen[ok]]).astype(np.int64)
    split = np.zeros(n_seqs, bool)
    if not len(ids):
        return split
    order = np.lexsort((starts, ids))
    ids, starts, ends, lens = ids[order], starts[order], ends[order], lens[order]
    first = np.concatenate([[True], ids[1:] != ids[:-1]])
    # running max of interval ends within each id segment (offset trick: make
    # the cummax monotone across segments by adding a per-segment offset)
    seg = np.cumsum(first) - 1
    off = (seg + 1) * (int(ends.max()) + 1)
    run = np.maximum.accumulate(ends + off) - off
    prev_run = np.concatenate([[0], run[:-1]])
    brk = (~first
           & (starts > prev_run - min_overlap)          # crossing overlap < m
           & (ends > prev_run)                          # actually extends reach
           # (advisor r4: a short interval CONTAINED in the running reach —
           # ends <= prev_run — proves nothing about a breakpoint there;
           # earlier alignments already span past it, so without this term a
           # clean read was false-flagged and its true junction silently
           # blocked)
           & (prev_run >= 2 * min_overlap)              # left side substantial
           & (starts <= lens - 2 * min_overlap))        # right side interior
    np.logical_or.at(split, ids[brk], True)
    return split


def build_edges(
    paf: PafRecords, cfg: ScaffoldConfig, n_seqs: int
) -> tuple[EdgeSoA, FilterStats]:
    """Filter PAF rows and emit the two directed edges per kept row.

    Scores here are the float32 numpy reference (kernels/scoring.py
    score_arrays_np); rescore_edges_device recomputes OS/ES on device and is
    tested for parity.
    Edge order is deterministic: kept rows in file order, forward edge then mirror edge
    interleaved per row.
    """
    if len(paf) and (int(paf.qid.max()) >= n_seqs or int(paf.tid.max()) >= n_seqs
                     or int(paf.qid.min()) < 0 or int(paf.tid.min()) < 0):
        raise ValueError(
            f"PAF sequence ids out of range [0, {n_seqs}) — name_index and "
            f"sequence sets disagree")
    g = overlap_geometry(paf)
    st = FilterStats(n_rows=len(paf))

    self_mask = paf.qid == paf.tid
    si_mask = g["si"] < cfg.min_identity
    mean_ol = (g["ol1"] + g["ol2"]) / 2.0
    short_mask = mean_ol < cfg.min_overlap
    internal_mask = (
        (np.minimum(g["lo_q"], g["lo_t"]) > cfg.max_overhang)
        & (np.minimum(g["ro_q"], g["ro_t"]) > cfg.max_overhang)
    )
    t_contained = (g["lo_t"] <= g["lo_q"]) & (g["ro_t"] <= g["ro_q"])
    q_contained = (g["lo_q"] <= g["lo_t"]) & (g["ro_q"] <= g["ro_t"])
    contained_mask = t_contained | q_contained

    # Junction overhangs depend on which node is left: left's right-overhang + right's
    # left-overhang. q is left iff lo_q > lo_t (tie -> containment already dropped it).
    q_left = g["lo_q"] > g["lo_t"]
    oh1 = np.where(q_left, g["ro_q"], g["ro_t"])
    oh2 = np.where(q_left, g["lo_t"], g["lo_q"])
    overhang_mask = (oh1 + oh2) > cfg.max_overhang_ratio * mean_ol

    # Sequential filter accounting (each row counted against the FIRST rule that drops it,
    # in the documented order 0..6):
    bad = malformed_mask(paf)
    st.n_malformed = int(bad.sum())
    st.n_self = int((self_mask & ~bad).sum())
    dropped = bad | self_mask
    for name, m in (
        ("n_low_identity", si_mask),
        ("n_short", short_mask),
        ("n_internal", internal_mask),
        ("n_contained", contained_mask),
        ("n_high_overhang", overhang_mask),
    ):
        newly = m & ~dropped
        setattr(st, name, int(newly.sum()))
        dropped |= m
    keep = ~dropped
    st.n_kept = int(keep.sum())

    idx = np.flatnonzero(keep)
    ql, tl = g["ql"][idx], g["tl"][idx]
    qs, qe = g["qs"][idx], g["qe"][idx]
    ts, te = g["ts"][idx], g["te"][idx]
    strand = paf.strand[idx].astype(np.int64)
    q_left = q_left[idx]

    # Oriented node ids of the aligned pair: q forward, t in `strand` orientation.
    q_node = 2 * paf.qid[idx].astype(np.int64)
    t_node = 2 * paf.tid[idx].astype(np.int64) + strand

    # Left/right node attributes in their oriented coordinates.
    l_node = np.where(q_left, q_node, t_node)
    r_node = np.where(q_left, t_node, q_node)
    l_len = np.where(q_left, ql, tl)
    r_len = np.where(q_left, tl, ql)
    l_s = np.where(q_left, qs, ts)
    l_e = np.where(q_left, qe, te)
    r_s = np.where(q_left, ts, qs)
    r_e = np.where(q_left, te, qe)

    oh1 = l_len - l_e            # left node's unaligned tail
    oh2 = r_s                    # right node's unaligned head
    el1 = l_s - r_s              # left extension
    el2 = (r_len - r_e) - (l_len - l_e)  # right extension
    ol1 = l_e - l_s
    ol2 = r_e - r_s
    # Scores via the shared float32 formula (kernels/scoring.py) — bit-identical to the
    # CPU jnp implementation (parity-tested in tests/test_scoring.py).
    from telomeri_tpu.kernels.scoring import score_arrays_np

    nm = paf.nmatch[idx]
    bl = paf.blocklen[idx]
    _, os_, es1, es2 = score_arrays_np(nm, bl, ol1, ol2, oh1, oh2, el1, el2)

    # Forward edge L -> R: splice R after L. Mirror edge rc(R) -> rc(L): coordinates
    # flip within each node (pos' = len - pos).
    n = len(idx)
    src = np.empty(2 * n, dtype=np.int64)
    dst = np.empty(2 * n, dtype=np.int64)
    es = np.empty(2 * n, dtype=np.float64)
    osb = np.empty(2 * n, dtype=np.float64)
    adv = np.empty(2 * n, dtype=np.int64)
    ue = np.empty(2 * n, dtype=np.int64)
    ve = np.empty(2 * n, dtype=np.int64)
    row = np.empty(2 * n, dtype=np.int64)

    src[0::2], dst[0::2] = l_node, r_node
    es[0::2], osb[0::2], adv[0::2] = es2, os_, el2
    ue[0::2], ve[0::2] = l_e, r_e
    src[1::2], dst[1::2] = r_node ^ 1, l_node ^ 1
    es[1::2], osb[1::2], adv[1::2] = es1, os_, el1
    ue[1::2], ve[1::2] = r_len - r_s, l_len - l_s
    row[0::2] = row[1::2] = idx

    def interleave(fwd, mir):
        out = np.empty(2 * n, dtype=np.int32)
        out[0::2], out[1::2] = fwd, mir
        return out

    edges = EdgeSoA(
        src=src.astype(np.int32), dst=dst.astype(np.int32),
        os_=osb.astype(np.float32), es=es.astype(np.float32),
        adv=adv.astype(np.int32), ue=ue.astype(np.int32), ve=ve.astype(np.int32),
        row=row.astype(np.int32),
        nm=interleave(nm, nm), bl=interleave(bl, bl),
        ol1=interleave(ol1, ol1), ol2=interleave(ol2, ol2),
        oh1=interleave(oh1, oh1), oh2=interleave(oh2, oh2),
        el=interleave(el2, el1),
    )
    return edges, st


def rescore_edges_device(edges: EdgeSoA) -> EdgeSoA:
    """Recompute edges.os_/es on the default JAX device (kernels/scoring.py
    score_os_es2_jnp). The device result replaces the host scores so ALL
    downstream decisions use one backend's arithmetic (kernels/scoring.py
    precision note)."""
    if len(edges) == 0:
        return edges
    from telomeri_tpu.kernels.scoring import score_os_es2_jnp

    os_, es2 = score_os_es2_jnp(*edges.geom_args())
    edges.os_ = np.asarray(os_)
    edges.es = np.asarray(es2)
    return edges
