"""Test harness: an 8-virtual-device CPU platform (SURVEY.md §5 item 5).

Must run before any jax import, hence the env mutation at module import time in
conftest (pytest imports conftest first). The CPU is forced unless JAX_PLATFORMS
names another platform: `JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist
tests/` runs the card's tests (tests/test_gpu.py) on the GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Build the native C++ helpers up front so the 11 native parity tests RUN by
# default instead of silently skipping (round-1 verdict hygiene item): the build
# is ~2 s with g++; if no compiler is present, warn visibly and let
# tests/test_native.py's skipif handle the rest.
from telomeri_tpu.native import align_native as _align_native  # noqa: E402
from telomeri_tpu.native import build as _native_build  # noqa: E402
from telomeri_tpu.native import paf_native as _paf_native  # noqa: E402

if not (_paf_native.available() and _align_native.available()):
    # also rebuilds a STALE library that predates the align helpers
    import shutil
    import warnings

    if shutil.which("g++"):
        _native_build.build(verbose=False)
        _paf_native._load_failed = False  # retry the (now-present) library
        _align_native._load_failed = False
        _paf_native._lib = _align_native._lib = None
    else:
        warnings.warn(
            "g++ not found: native parser library not built; native parity "
            "tests will SKIP and the pipeline will use the Python parsers",
            stacklevel=1)


@pytest.fixture(scope="session")
def toy_sim():
    """Small simulated dataset shared across tests."""
    from telomeri_tpu.sim import SimConfig, simulate

    return simulate(SimConfig(genome_len=30_000, repeat_len=2_000, n_repeat_copies=2,
                              read_len_mean=1_500, read_len_sd=200, coverage=15.0,
                              error_rate=0.02, seed=1))


@pytest.fixture(scope="session")
def toy_dataset_dir(tmp_path_factory, toy_sim):
    from telomeri_tpu.sim import write_dataset

    d = tmp_path_factory.mktemp("toy")
    write_dataset(toy_sim, str(d))
    return str(d)


@pytest.fixture()
def rng():
    return np.random.default_rng(42)
