"""Tests that run on an NVIDIA GPU and skip elsewhere.

Run on the card: JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist tests/
(tests/conftest.py forces the CPU unless JAX_PLATFORMS names another platform).
Whether a GPU is present is decided inside the `gpu` fixture, never at import.
"""

import os

import numpy as np
import pytest

from test_scoring import args as geom_args
from test_scoring import random_geom
from test_walk import random_graph

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(__file__), "..", "testdata", "lambda")


@pytest.fixture(scope="module")
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default backend is {dev.platform}")
    return dev


def test_lambda_golden_on_gpu(gpu, tmp_path):
    from telomeri_tpu.config import ScaffoldConfig
    from telomeri_tpu.pipeline import run_pipeline

    cfg = ScaffoldConfig.from_json(open(os.path.join(DATA, "config.json")).read())
    out = str(tmp_path / "scaffolds.fa")
    run_pipeline(*[os.path.join(DATA, f) for f in (
        "contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")], out, cfg)
    assert open(out, "rb").read() == \
        open(os.path.join(DATA, "golden_scaffolds.fa"), "rb").read()


@pytest.mark.parametrize("kind", ["mixed", "greedy", "mc"])
def test_engine_matches_oracle_on_gpu(gpu, kind):
    """Every WalkResult field, bit for bit, for each specialised scan."""
    from telomeri_tpu.config import ScaffoldConfig
    from telomeri_tpu.walk.engine import (
        _run_walks_kind, _slice_plan, graph_to_device, plan_to_device)
    from telomeri_tpu.walk.oracle import jax_choice_fn, walk_oracle
    from telomeri_tpu.walk.plan import plan_walks

    g = random_graph(np.random.default_rng(5), n_seqs=400, n_anchors=20, k=16)
    plan = plan_walks(g, ScaffoldConfig(mc_walks_per_end=8, max_steps=12))
    if kind != "mixed":
        plan = _slice_plan(plan, *plan.sections[kind])
    r = _run_walks_kind(graph_to_device(g), plan_to_device(plan), 3,
                        n_anchors=g.n_anchors, max_steps=12, kind=kind).to_numpy()
    choice = jax_choice_fn(3, 12)
    for i in np.flatnonzero(plan.active):
        o = walk_oracle(g, int(plan.start[i]), int(plan.first_edge[i]),
                        int(plan.mode[i]), int(plan.uid[i]), 12, choice)
        assert r.nodes[i].tolist() == o.nodes + [-1] * (13 - len(o.nodes)), i
        assert r.eids[i].tolist() == o.eids + [-1] * (12 - len(o.eids)), i
        assert (int(r.steps[i]), bool(r.success[i]), int(r.terminal[i]),
                int(r.path_len[i])) == (o.steps, o.success, o.terminal,
                                        o.path_len), i
        assert np.float32(r.score_sum[i]) == np.float32(o.score_sum), i


@pytest.mark.parametrize("n", [1, 4097, 1 << 20])
def test_scoring_jnp_within_stated_ulps_on_gpu(gpu, n):
    """XLA's GPU float32 division is not correctly rounded: SI within 2 ulp and
    OS within 3 ulp of numpy (kernels/scoring.py precision note)."""
    import jax

    from telomeri_tpu.kernels.scoring import score_arrays_np, score_overlaps_jnp

    g = random_geom(np.random.default_rng(n), n)
    ref = score_arrays_np(*geom_args(g))
    got = score_overlaps_jnp(*[jax.device_put(a, gpu) for a in geom_args(g)])
    assert got[0].devices() == {gpu}
    ulp = lambda a, b: np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                              - b.view(np.int32).astype(np.int64)).max()
    assert ulp(got[0], ref[0]) <= 2 and ulp(got[1], ref[1]) <= 3
