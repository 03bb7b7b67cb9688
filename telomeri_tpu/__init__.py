"""telomeri-tpu: a repeat-resolving genome scaffolder (HERA-style) in JAX.

Built from scratch with the capabilities of the C++ reference tool `lirfu/Telomeri`
(SURVEY.md; the reference mount was empty every round so far — see SURVEY.md §0 for
provenance). Layer map (SURVEY.md §2.2):

  io/         host ingest: FASTA/FASTQ + PAF -> SoA, overlap geometry + filtering
  graph/      fixed-shape padded-CSR graph encoding (device memory)
  kernels/    extension-score formula: numpy oracle + jnp device implementation
  walk/       batched greedy + Monte-Carlo walk engine (device)
  consensus/  path dedup, length-histogram grouping, representative selection (device)
  dist/       device mesh, sharded walk batches, all-gather/psum merge
  scaffold/   bridge conflict resolution + sequence stitching (host)
  cli/        `telomeri-tpu` entry point
  native/     C++ fast parsers (ctypes; optional, parity-tested)
"""

__version__ = "0.1.0"

from telomeri_tpu.config import DEFAULT_CONFIG, ScaffoldConfig  # noqa: F401
