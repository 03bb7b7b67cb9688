"""Pipeline configuration.

The C++ reference (lirfu/Telomeri, unreadable this round — see SURVEY.md §0) hardcodes its
thresholds; we centralise every knob in one dataclass (SURVEY.md §6 "Config / flag system")
and serialise it into every output for reproducibility.

All threshold semantics are documented PRECISELY here because bit-identical output depends on
boundary conditions (SURVEY.md §7 "hard parts"). Until the reference mount is readable these
are OUR normative rules; reconcile against the reference the moment it appears.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ScaffoldConfig:
    """All knobs of the scaffolding pipeline.

    Filtering rules (applied in `io/geometry.py`, in this order, on each PAF row):
      0. malformed:      internally inconsistent arithmetic (coords past
                         sequence ends, qe <= qs / te <= ts, nmatch > blocklen,
                         non-positive lengths/blocklen, negative starts) -> drop
                         (round 4; geometry.malformed_mask — no untrusted row
                          reaches the geometry/score/stitch math)
      1. self-overlap:   query name == target name                        -> drop
      2. min identity:   SI = nmatch / blocklen;  SI <  min_identity      -> drop
      3. min overlap:    mean aligned span (OL1+OL2)/2 <  min_overlap     -> drop
      4. internal match: min(lo_q, lo_t) > max_overhang AND
                         min(ro_q, ro_t) > max_overhang                   -> drop
         (lo/ro = left/right unaligned overhang of each sequence, in
          target-orientation-corrected coordinates)
      5. containment:    (lo_t <= lo_q AND ro_t <= ro_q)  [t contained]   -> drop
                         (lo_q <= lo_t AND ro_q <= ro_t)  [q contained]   -> drop
         (ties, i.e. exactly equal spans, count as containment -> drop)
      6. overhang ratio: at the junction, OH1 + OH2 > max_overhang_ratio * (OL1+OL2)/2 -> drop

    Scoring (HERA formulas, SURVEY.md §3 row 5):
        SI  = nmatch / blocklen
        OS  = SI * (OL1 + OL2) / 2
        ES2 = OS + EL2/2 - (OH1 + OH2)/2     # extend right with the right-hand node
        ES1 = OS + EL1/2 - (OH1 + OH2)/2     # extend left  with the left-hand node
    where, with q the left node (lo_q > lo_t):
        OL1 = qe - qs, OL2 = te' - ts'       (te'/ts' target coords, orientation-corrected)
        OH1 = ql - qe  (left node's unaligned tail), OH2 = ts' (right node's unaligned head)
        EL1 = lo_q - lo_t = qs - ts'         (left node's extension past the right node)
        EL2 = ro_t - ro_q = (tl - te') - (ql - qe)
    Ties everywhere break deterministically (documented at each site).
    """

    # --- overlap filtering ---
    min_identity: float = 0.70     # minimum SI to keep an overlap
    min_overlap: int = 100         # minimum mean aligned span (bp)
    max_overhang: int = 1000       # internal-match overhang threshold (bp)
    max_overhang_ratio: float = 0.8  # junction overhang sum vs mean overlap span

    # --- graph tensorization ---
    max_degree: int = 64           # CSR row width K; keep top-K out-edges by (ES desc, dst asc)
    # "auto": rescore edges on the device when an accelerator is the default
    # backend AND the edge count is at least 32M rows (pipeline.py) — below
    # that the host numpy scores stand (same fp32 op order; bit-identical on
    # the CPU, within a few ulp on the GPU — kernels/scoring.py). "on"/"off"
    # force it. One backend scores the whole run, so results stay
    # deterministic (kernels/scoring.py precision note).
    device_scoring: str = "auto"

    # --- host ingest ---
    # lazy mmap-backed sequence store: "auto" for plain files >= 1 GiB, "on"/"off"
    # force it. Element-identical to the eager parser; fixes host RAM at
    # whole-genome scale (docs/ARCHITECTURE.md memory budget).
    lazy_sequences: str = "auto"

    # --- path generation ---
    # Monte-Carlo repetitions per anchor end. Raised 100 -> 1000 in round 4:
    # with density-INVARIANT read-diverse support (support_mode below) extra
    # walks can only discover more distinct paths, never inflate a chimera's
    # support — hg002-sub's whole production batch at 1000/end is still under
    # 1M walks, and bridges sampling-limited gaps (gap 354) in the BASE round
    # instead of needing a rescue round.
    mc_walks_per_end: int = 1000
    max_steps: int = 32            # fixed walk length bound (nodes beyond the start anchor)
    mc_seed: int = 0               # base PRNG seed; per-walk streams via fold_in(walk_uid)
    # (a two-phase MC scan knob, mc_phase_steps, existed rounds 2-4; its final
    # fully-on-device form still measured slower than the one-phase scan on
    # every graph class, so the machinery was removed — BASELINE.md
    # "Two-phase MC scan" records the numbers. from_json drops the old key.)

    # --- path grouping / consensus ---
    # "windowed" (HERA sparse-region split: sorted path lengths split where
    # adjacent lengths differ by > group_window) or "fixed" (bucket =
    # path_len // group_window) — consensus/grouping.py rule 3
    grouping: str = "windowed"
    group_window: int = 1000       # path-length gap / bucket width (bp)
    min_group_support: int = 2     # winning group must hold >= this many support units
    # support unit (consensus/grouping.py rule 6): "read_diverse" (default since
    # round 4) gates on DISTINCT paths per group plus the cut-read rule with
    # split-read discrimination (consensus/evidence.py) — density-invariant
    # and chimera-proof, so mc_walks_per_end can rise freely. "walk_count" is
    # the rounds-1-3 raw walk count (density-inflated; kept for comparability).
    support_mode: str = "read_diverse"
    # split-read (chimera-signature) detection margin: a read with an interior
    # BREAKPOINT — a position where consecutive alignment clusters overlap by
    # fewer than this many bp (no alignment spans it) — is SPLIT-MAPPED
    # (io/geometry.py split_mapped); a cut read that is NOT split is a clean
    # spanning read and its bridge is accepted. 0 disables detection — every
    # cut-read pair is then refused-and-blocked (conservative; also the
    # fallback for pre-round-4 graph artifacts).
    split_read_margin: int = 100

    # --- copy-coherence demotion (consensus/coherence.py; round 5) ---
    # A cross-copy (wrong-locus) alignment's identity sits ~copy-divergence
    # below the TOP of its reads' incident-SI distributions. A pair is
    # "coherent" when some distinct path keeps every edge within this margin
    # of that top (rel >= margin); incoherent pairs rank BELOW coherent ones
    # at equal count in conflict resolution — re-ordering only, never a
    # refusal, so divergence-free datasets are unaffected. Measured margins
    # on the failing hg002-sub instance: wrong pairs' best <= +0.0007, true
    # pairs' best >= +0.0126 (BASELINE.md case study). 0 disables.
    copy_coherence_margin: float = 0.005

    # --- junction polish (scaffold/polish.py; round 5) ---
    # Gap fills splice RAW read bases, so junction identity is ceilinged at
    # the read error rate. polish=True re-calls every fill base by plurality
    # vote over the OTHER reads spanning that junction (the winning group's
    # distinct paths name them): each spanning read is anchored to the fill
    # by unique k-mers, inter-anchor gaps align exactly (DP with traceback),
    # and an edit (sub/del/ins) applies only when >= 2 reads agree AND they
    # outnumber half the covering reads — deterministic, and a 50/50 het
    # split keeps the rep read's allele. Edits are confined to read-sourced
    # fill segments; contig bases are never touched. With polish on, AGP
    # source-component coordinates describe the PRE-polish splice (the
    # byte-exact round-trip holds only for unpolished output).
    polish: bool = False
    polish_flank: int = 96         # anchoring context into the neighbours (bp)

    # --- rescue rounds (walk/rescue.py) ---
    # after conflict resolution, re-walk still-free walkable contig ends at
    # this density; a rescue bridge needs >= min_group_support DISTINCT paths
    # with NO common cut read (read-diverse evidence — walk counts are
    # density-inflated and chimera-blind). 0 rounds disables.
    rescue_rounds: int = 1
    rescue_walks_per_end: int = 2000

    # --- sharding ---
    walk_batch_multiple: int = 8   # pad walk batch to a multiple of this * n_devices
    # upper bound on walks per device DISPATCH (single-device path): plans
    # larger than this run in deterministic chunks — records are uid-keyed, so
    # chunked ≡ unchunked bitwise (the core RNG invariant). It bounds the
    # records + scan temps of one dispatch: the FULL hg002 preset (3 Gb) plans
    # millions of walks, whose single-dispatch records would take tens of GB.
    # The value predates the GPU port; deriving it from the device's
    # memory_stats() is open (ROADMAP.md §3). 0 disables chunking.
    max_walk_batch: int = 1 << 21
    # "replicated": graph on every device (fastest; graph must fit one card);
    # "rowshard": CSR rows sharded over the mesh (>HBM graphs; each walk step
    # fetches rows via collectives — dist/rowshard.py; requires --mesh);
    # "auto": replicated unless the device tables exceed ~75% of one device's
    # memory AND a multi-device mesh is available, then rowshard (pipeline.py).
    graph_placement: str = "auto"

    def __post_init__(self) -> None:
        if self.device_scoring not in ("auto", "on", "off"):
            raise ValueError(
                f"device_scoring must be auto/on/off, got {self.device_scoring!r}")
        if self.lazy_sequences not in ("auto", "on", "off"):
            raise ValueError(
                f"lazy_sequences must be auto/on/off, got {self.lazy_sequences!r}")
        if self.grouping not in ("windowed", "fixed"):
            raise ValueError(
                f"grouping must be windowed/fixed, got {self.grouping!r}")
        if self.support_mode not in ("read_diverse", "walk_count"):
            raise ValueError(
                f"support_mode must be read_diverse/walk_count, "
                f"got {self.support_mode!r}")
        if self.graph_placement not in ("auto", "replicated", "rowshard"):
            raise ValueError(
                f"graph_placement must be auto/replicated/rowshard, "
                f"got {self.graph_placement!r}")
        for f in ("min_identity", "max_overhang_ratio"):
            v = getattr(self, f)
            if not 0.0 <= v <= 10.0:
                raise ValueError(f"{f}={v} out of range")
        for f in ("min_overlap", "max_overhang", "mc_walks_per_end",
                  "rescue_rounds", "rescue_walks_per_end", "split_read_margin"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")
        if self.rescue_rounds > 63:
            # rescue uids live at RESCUE_UID_BASE + round*(1<<24) and must
            # stay inside int32 (walk/rescue.py)
            raise ValueError(
                f"rescue_rounds must be <= 63, got {self.rescue_rounds}")
        # structurally positive: zero breaks padding/bucketing/argmax downstream
        for f in ("max_degree", "max_steps", "group_window", "min_group_support",
                  "walk_batch_multiple"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    # fields that existed in earlier framework versions and were removed;
    # configs carrying them (old artifact headers, saved run configs) load
    # with a warning instead of erroring
    _LEGACY_KEYS = frozenset({"mc_phase_steps"})

    @staticmethod
    def from_json(s: str, strict: bool = True) -> "ScaffoldConfig":
        """Load a config from JSON.

        strict (default — the user-supplied --config path): an unknown key
        that is not a known-removed legacy field raises with a did-you-mean
        hint; a typo like 'min_identitiy' silently falling back to the
        default (the round-4 behavior — advisor r4 item 4) cost exactly the
        run it was meant to configure. strict=False keeps the fully tolerant
        behavior for machine-written inputs (e.g. replaying an old saved
        config verbatim)."""
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(ScaffoldConfig)}
        unknown = sorted(set(d) - known)
        legacy = [k for k in unknown if k in ScaffoldConfig._LEGACY_KEYS]
        bogus = [k for k in unknown if k not in ScaffoldConfig._LEGACY_KEYS]
        if legacy:
            from telomeri_tpu.utils.logging import log

            log.warning("config: dropping removed legacy field(s) %s", legacy)
        if bogus:
            if strict:
                import difflib

                hints = []
                for k in bogus:
                    close = difflib.get_close_matches(k, known, n=1)
                    hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                             if close else ""))
                raise ValueError(
                    "unknown config field(s): " + ", ".join(hints))
            from telomeri_tpu.utils.logging import log

            log.warning("config: dropping unknown field(s) %s", bogus)
        return ScaffoldConfig(**{k: v for k, v in d.items() if k in known})


DEFAULT_CONFIG = ScaffoldConfig()
