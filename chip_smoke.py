"""On-card smoke test: the scaffold pipeline's main path on NVIDIA GPUs.

    python chip_smoke.py           # one card: phases 0-5 below
    python chip_smoke.py --multi   # four cards: the E. coli pipeline on a 4-card
                                   # mesh, replicated and row-sharded, against
                                   # the 1-card FASTA (and nothing else)

Phases (one card), each fatal on failure:
  0. device check: JAX's devices must be GPUs; prints device_kind, count, the
     card's nvidia-smi name and power limit, the JAX version and the compile cache.
  1. lambda golden: `scaffold` on testdata/lambda through the CLI; the FASTA must
     be byte-identical to testdata/lambda/golden_scaffolds.fa.
  2. the main path at real size: the `ecoli` simulator preset (4.6 Mb genome)
     scaffolded through the CLI with the default config on the GPU (with --agp and
     --trace) and again in a CPU-only process; the two FASTA files must be
     byte-identical, and `validate` on the GPU output must count zero misjoins.
  3. the walk engine at whole-human table size: a 49,152-walk MC batch on the
     synthetic HG002-scale table (6,291,456 nodes, K=64, ~9 GiB on the card);
     512 evenly spaced walks must equal walk/oracle.py in every field, bit for bit.
  4. scoring: score_overlaps_jnp at 64M rows against the numpy oracle, and
     rescore_edges_device on the E. coli edges against build_edges' host scores,
     within the ulp bounds kernels/scoring.py states.
  5. the GPU-marked tests: `pytest -m gpu` with JAX_PLATFORMS=cuda.

One process per card: this parent never initialises a JAX backend. Every device
phase runs in a child process of its own (a CLI run, pytest, or a spawned worker),
one at a time, so only one process ever holds the card.

The last stdout line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LAMBDA = os.path.join(ROOT, "testdata", "lambda")
# environment of the device-side CLI children; a child that finds no GPU fails
GPU_ENV = {"JAX_PLATFORMS": "cuda"}


def say(*a) -> None:
    print(*a, flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def in_child(fn, *args):
    """Run fn(*args) in a fresh spawned process and return its result; the
    process exits (releasing the card) before this returns."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as ex:
        return ex.submit(fn, *args).result()


def run_cli(args: list[str], env: dict, what: str) -> subprocess.CompletedProcess:
    """python -m telomeri_tpu.cli.main ARGS from the checkout root; stderr
    passes through, stdout is captured and returned."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "telomeri_tpu.cli.main", *args],
                       cwd=ROOT, env={**os.environ, **env}, stdout=subprocess.PIPE,
                       text=True)
    say(f"  {what}: rc={p.returncode} in {time.perf_counter() - t0:.1f}s")
    check(p.returncode == 0, f"{what} exited {p.returncode}")
    return p


def scaffold_args(d: str, out: str) -> list[str]:
    return ["scaffold", "--contigs", f"{d}/contigs.fa", "--reads", f"{d}/reads.fa",
            "--paf-read-contig", f"{d}/read2contig.paf",
            "--paf-read-read", f"{d}/read2read.paf", "--out", out]


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# Phase bodies that need a JAX backend: each runs in its own spawned child.
# ---------------------------------------------------------------------------

def device_check() -> dict:
    import jax

    from telomeri_tpu.utils.compile_cache import enable_compile_cache
    from telomeri_tpu.utils.device import require_gpu

    cache = enable_compile_cache()
    dev = require_gpu()
    say(f"  device_kind={dev['kind']} count={dev['count']} jax={jax.__version__} "
        f"compile_cache={cache}")
    return dev


def walks_vs_oracle(n_nodes: int, n_walks: int, n_check: int,
                    max_steps: int = 32, seed: int = 1) -> None:
    """Phase 3: production kind="mc" batch on the synthetic table; n_check
    evenly spaced walks against walk/oracle.py, every WalkResult field."""
    import jax
    import numpy as np

    from bench import hg002_scale_graph, hg002_scale_plan
    from telomeri_tpu.utils.compile_cache import enable_compile_cache
    from telomeri_tpu.walk.engine import _run_walks_kind, graph_to_device, plan_to_device
    from telomeri_tpu.walk.oracle import jax_choice_fn, walk_oracle

    enable_compile_cache()
    t0 = time.perf_counter()
    g = hg002_scale_graph(n=n_nodes)
    say(f"  table built on the host in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    gd = graph_to_device(g)
    jax.block_until_ready(gd)
    gib = gd.wide.size * gd.wide.dtype.itemsize / 2**30
    say(f"  device table {gd.wide.shape} int32 = {gib:.2f} GiB, "
        f"uploaded in {time.perf_counter() - t0:.1f}s")
    plan = hg002_scale_plan(n_walks, g.n_anchors)
    pd = plan_to_device(plan)
    t0 = time.perf_counter()
    compiled = _run_walks_kind.lower(gd, pd, seed, n_anchors=g.n_anchors,
                                     max_steps=max_steps, kind="mc").compile()
    say(f"  step compiled in {time.perf_counter() - t0:.1f}s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    res = compiled(gd, pd, seed, n_anchors=g.n_anchors)
    jax.block_until_ready(res)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(gd, pd, seed, n_anchors=g.n_anchors))
        times.append(time.perf_counter() - t0)
    say(f"  {n_walks} walks x {max_steps} steps: median "
        f"{np.median(times) * 1e3:.2f} ms/call over 5")
    res = res.to_numpy()
    check(bool((res.steps > 0).any()), "no walk took a step")
    choice = jax_choice_fn(seed, max_steps)
    rows = np.linspace(0, n_walks - 1, n_check).astype(int)
    for i in rows:
        o = walk_oracle(g, int(plan.start[i]), -1, int(plan.mode[i]),
                        int(plan.uid[i]), max_steps, choice)
        want_nodes = o.nodes + [-1] * (max_steps + 1 - len(o.nodes))
        want_eids = o.eids + [-1] * (max_steps - len(o.eids))
        check(res.nodes[i].tolist() == want_nodes, f"walk {i}: nodes differ")
        check(res.eids[i].tolist() == want_eids, f"walk {i}: eids differ")
        check(int(res.steps[i]) == o.steps, f"walk {i}: steps differ")
        check(bool(res.success[i]) == o.success, f"walk {i}: success differs")
        check(int(res.terminal[i]) == o.terminal, f"walk {i}: terminal differs")
        check(int(res.path_len[i]) == o.path_len, f"walk {i}: path_len differs")
        check(np.float32(res.score_sum[i]).tobytes()
              == np.float32(o.score_sum).tobytes(), f"walk {i}: score_sum differs")
    say(f"  {len(rows)} walks bit-identical to walk/oracle.py ("
        f"{int((res.steps[rows] == max_steps).sum())} ran all {max_steps} steps, "
        f"the rest were cycle-killed)")


def scoring_vs_numpy(n_rows: int, dataset: str) -> None:
    """Phase 4: jnp scoring against numpy at n_rows, and the device rescore of
    the E. coli edges against build_edges' host scores, within the bounds
    kernels/scoring.py states (XLA's GPU f32 division is not correctly
    rounded)."""
    import copy

    import jax
    import numpy as np

    from bench import scoring_inputs
    from telomeri_tpu.config import ScaffoldConfig
    from telomeri_tpu.io.geometry import build_edges, rescore_edges_device
    from telomeri_tpu.kernels.scoring import score_arrays_np, score_overlaps_jnp
    from telomeri_tpu.pipeline import load_inputs
    from telomeri_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ulp = lambda a, b: np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                              - np.asarray(b).view(np.int32).astype(np.int64))
    geom = scoring_inputs(n_rows)
    ref = score_arrays_np(*geom)
    got = jax.device_get(score_overlaps_jnp(*[jax.device_put(a) for a in geom]))
    d = [ulp(g, r) for g, r in zip(got, ref)]
    say(f"  score_overlaps_jnp: {n_rows:,} rows; max ulp from numpy: si {d[0].max()} "
        f"({(d[0] > 0).mean():.1%} of rows), os {d[1].max()}; es1/es2 max abs "
        f"{max(np.abs(got[2] - ref[2]).max(), np.abs(got[3] - ref[3]).max())}")
    check(d[0].max() <= 2 and d[1].max() <= 3,
          "score_overlaps_jnp outside the bounds kernels/scoring.py states")

    contigs, reads, paf = load_inputs(*[
        os.path.join(dataset, f) for f in
        ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")])
    edges, _ = build_edges(paf, ScaffoldConfig(), len(contigs) + len(reads))
    dev = rescore_edges_device(copy.deepcopy(edges))
    d_os = ulp(dev.os_, edges.os_)
    say(f"  rescore_edges_device: {len(edges):,} edges; os max {d_os.max()} ulp "
        f"({(d_os > 0).mean():.1%} differ), es max abs "
        f"{np.abs(dev.es - edges.es).max()} from the host scores")
    check(d_os.max() <= 3, "rescore_edges_device outside the stated bound")


# ---------------------------------------------------------------------------
# Phases driven from the parent (which stays off JAX).
# ---------------------------------------------------------------------------

def phase_lambda(work: str) -> None:
    out = os.path.join(work, "lambda.fa")
    run_cli(scaffold_args(LAMBDA, out) + ["--config", f"{LAMBDA}/config.json"],
            GPU_ENV, "scaffold lambda (GPU)")
    check(read_bytes(out) == read_bytes(f"{LAMBDA}/golden_scaffolds.fa"),
          "lambda FASTA differs from testdata/lambda/golden_scaffolds.fa")
    say("  lambda FASTA byte-identical to the golden")


def simulate_ecoli(work: str, preset: str) -> str:
    data = os.path.join(work, preset)
    run_cli(["simulate", "--preset", preset, "--out", data], {},
            f"simulate --preset {preset}")
    return data


def build_native() -> None:
    """The native PAF/FASTA parsers (optional; the pipeline falls back to the
    Python parsers without them)."""
    if shutil.which("g++"):
        subprocess.run([sys.executable, "-m", "telomeri_tpu.native.build"],
                       cwd=ROOT, check=True, stdout=subprocess.DEVNULL)
        say("  native parsers built")
    else:
        say("  no g++: the Python parsers will run")


def phase_pipeline(work: str, data: str, card: str) -> bytes:
    gpu = os.path.join(work, "ecoli_gpu.fa")
    trace = os.path.join(work, "trace")
    run_cli(scaffold_args(data, gpu) + ["--agp", gpu + ".agp", "--trace", trace],
            GPU_ENV, "scaffold ecoli (GPU, default config)")
    check(bool(glob.glob(f"{trace}/**/*.xplane.pb", recursive=True)),
          f"no profiler trace written under {trace}")
    say("  profiler trace written")
    cpu = os.path.join(work, "ecoli_cpu.fa")
    run_cli(scaffold_args(data, cpu), {"JAX_PLATFORMS": "cpu"},
            "scaffold ecoli (CPU-only process)")
    fasta = read_bytes(gpu)
    check(len(fasta) > 0, "empty ecoli FASTA")
    check(fasta == read_bytes(cpu), "ecoli FASTA differs between GPU and CPU")
    say(f"  ecoli FASTA byte-identical GPU vs CPU ({len(fasta):,} bytes)")
    rep = json.loads(run_cli(
        ["validate", "--scaffolds", gpu, "--genome", f"{data}/genome.fa",
         "--agp", gpu + ".agp"], {}, "validate ecoli (GPU output)").stdout)
    say(f"  validate: {rep['n_scaffolds']} scaffolds, placed_fraction "
        f"{rep['placed_fraction']}, mean_identity {rep['mean_identity']}, "
        f"worst_junction_identity {rep.get('worst_junction_identity')}, "
        f"misjoins {rep.get('n_misjoins')}")
    check(rep.get("n_misjoins") == 0, "validate counted misjoins")
    with open(gpu + ".metrics.json") as f:
        m = json.load(f)
    say(f"  stage timers (s) on {card}, GPU run:")
    for stage, s in m["timings_s"].items():
        say(f"    {stage:24s} {s:9.3f}")
    say(f"  cold-compile time (XLA backend compiles) {m['metrics']['compile_s']:.3f}s "
        f"of that, cache {m['metrics']['compile_cache_dir']}")
    return fasta


def phase_gpu_tests() -> None:
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-p", "no:xdist",
         "-p", "no:cacheprovider", "-q", "-rs", "tests/"],
        cwd=ROOT, env={**os.environ, **GPU_ENV}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    tail = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    say(f"  pytest -m gpu: rc={p.returncode} in {time.perf_counter() - t0:.1f}s: "
        f"{tail}")
    check(p.returncode == 0, "GPU-marked tests failed:\n" + p.stdout[-4000:])
    check(" passed" in tail and "skipped" not in tail,
          "GPU-marked tests did not all run on the card:\n" + p.stdout[-4000:])


def phase_multi(work: str, data: str, n_cards: int) -> None:
    one = os.path.join(work, "ecoli_1card.fa")
    run_cli(scaffold_args(data, one), GPU_ENV, "scaffold ecoli (1 card)")
    ref = read_bytes(one)
    check(len(ref) > 0, "empty 1-card FASTA")
    for name, extra in (("replicated", []),
                        ("rowshard", ["--graph-placement", "rowshard"])):
        out = os.path.join(work, f"ecoli_{n_cards}card_{name}.fa")
        run_cli(scaffold_args(data, out) + ["--mesh", str(n_cards), *extra],
                GPU_ENV, f"scaffold ecoli (--mesh {n_cards}, {name})")
        check(read_bytes(out) == ref,
              f"{n_cards}-card {name} FASTA differs from the 1-card FASTA")
        say(f"  {n_cards}-card {name} FASTA byte-identical to 1 card "
            f"({len(ref):,} bytes)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card mesh phase (needs 4 GPUs)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    phase = "0 device check"
    try:
        say(f"phase {phase}")
        dev = in_child(device_check)
        from telomeri_tpu.utils.device import gpu_cards

        cards = gpu_cards()
        for c in cards:
            say(f"  card: {c}")
        card = cards[0]
        build_native()
        if args.multi:
            check(dev["count"] == 4, f"--multi needs 4 GPUs, JAX sees {dev['count']}")
            phase = "multi: ecoli on a 4-card mesh vs 1 card"
            say(f"phase {phase}")
            phase_multi(work, simulate_ecoli(work, "ecoli"), 4)
        else:
            phase = "1 lambda golden"
            say(f"phase {phase}")
            phase_lambda(work)
            phase = "2 ecoli pipeline, GPU vs CPU"
            say(f"phase {phase}")
            data = simulate_ecoli(work, "ecoli")
            phase_pipeline(work, data, card)
            phase = "3 walk engine at HG002 table size vs oracle"
            say(f"phase {phase}")
            in_child(walks_vs_oracle, 6_291_456, 49_152, 512)
            phase = "4 scoring vs numpy"
            say(f"phase {phase}")
            in_child(scoring_vs_numpy, 64 * 2**20, data)
            phase = "5 GPU-marked tests"
            say(f"phase {phase}")
            phase_gpu_tests()
    except Exception as e:  # report the phase that failed, then exit non-zero
        say(f"FAILED in phase {phase}: {type(e).__name__}: {e}")
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"all phases passed in {time.perf_counter() - t_start:.1f}s on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
