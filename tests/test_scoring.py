"""Scoring parity tests: jnp ≡ numpy oracle (SURVEY.md §5 item 2)."""

import numpy as np
import pytest

from telomeri_tpu.kernels.scoring import (
    score_arrays_np,
    score_os_es2_jnp,
    score_overlaps,
    score_overlaps_jnp,
)


def random_geom(rng, n):
    return dict(
        nm=rng.integers(1, 5000, n).astype(np.int32),
        bl=rng.integers(1, 6000, n).astype(np.int32),
        ol1=rng.integers(0, 6000, n).astype(np.int32),
        ol2=rng.integers(0, 6000, n).astype(np.int32),
        oh1=rng.integers(0, 2000, n).astype(np.int32),
        oh2=rng.integers(0, 2000, n).astype(np.int32),
        el1=rng.integers(-1000, 30000, n).astype(np.int32),
        el2=rng.integers(-1000, 30000, n).astype(np.int32),
    )


def args(g):
    return (g["nm"], g["bl"], g["ol1"], g["ol2"], g["oh1"], g["oh2"], g["el1"], g["el2"])


def test_golden_values():
    # SI=0.9, OL=200 each -> OS=180; pen=0; EL=800 -> ES=580 (hand-computed, HERA formulas)
    si, os_, es1, es2 = score_arrays_np(
        np.array([180]), np.array([200]), np.array([200]), np.array([200]),
        np.array([0]), np.array([0]), np.array([800]), np.array([800]),
    )
    assert si[0] == pytest.approx(0.9)
    assert os_[0] == pytest.approx(180.0)
    assert es1[0] == es2[0] == pytest.approx(580.0)


@pytest.mark.parametrize("n", [1, 127, 128, 1000, 4097, 32768, 70001])
def test_jnp_matches_np_bitwise(rng, n):
    g = random_geom(rng, n)
    ref = score_arrays_np(*args(g))
    got = score_overlaps_jnp(*args(g))
    for r, o in zip(ref, got):
        assert o.shape == (n,)
        np.testing.assert_array_equal(r, np.asarray(o))


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret", "triton"])
def test_score_overlaps_rejects_unknown_backend(rng, backend):
    g = random_geom(rng, 8)
    with pytest.raises(ValueError, match="auto/jnp"):
        score_overlaps(*args(g), backend=backend)
    ref = score_arrays_np(*args(g))
    for ok in ("auto", "jnp"):
        for r, o in zip(ref, score_overlaps(*args(g), backend=ok)):
            np.testing.assert_array_equal(r, np.asarray(o))


def test_os_es2_half_matches_full_formula(rng):
    """score_os_es2_jnp (the device rescore path) returns exactly the os and
    es2 columns of the 4-output formula."""
    g = random_geom(rng, 9000)
    _, os_ref, _, es2_ref = score_arrays_np(*args(g))
    os_, es2 = score_os_es2_jnp(*args(g))
    np.testing.assert_array_equal(os_ref, np.asarray(os_))
    np.testing.assert_array_equal(es2_ref, np.asarray(es2))


def test_rescore_edges_device_matches_host_scores(toy_dataset_dir):
    """The device rescore path (io/geometry.py rescore_edges_device) writes the
    same OS/ES bits that build_edges computed on the host with numpy."""
    import copy
    import os

    from telomeri_tpu.config import ScaffoldConfig
    from telomeri_tpu.io.geometry import build_edges, rescore_edges_device
    from telomeri_tpu.pipeline import load_inputs

    contigs, reads, paf = load_inputs(*[
        os.path.join(toy_dataset_dir, f) for f in
        ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")])
    edges, _ = build_edges(paf, ScaffoldConfig(), len(contigs) + len(reads))
    assert len(edges) > 0
    host_os, host_es = edges.os_.copy(), edges.es.copy()
    dev = rescore_edges_device(copy.deepcopy(edges))
    assert dev.os_.dtype == np.float32 and dev.es.dtype == np.float32
    np.testing.assert_array_equal(host_os, dev.os_)
    np.testing.assert_array_equal(host_es, dev.es)


def test_zero_blocklen_guard():
    si, *_ = score_arrays_np(
        np.array([10]), np.array([0]), np.array([1]), np.array([1]),
        np.array([0]), np.array([0]), np.array([0]), np.array([0]),
    )
    assert np.isfinite(si[0]) and si[0] == 10.0  # nm / max(bl,1)
