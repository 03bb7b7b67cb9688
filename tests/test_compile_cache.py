"""Compile-cache placement (telomeri_tpu/utils/compile_cache.py): JAX's own
JAX_COMPILATION_CACHE_DIR stands when set; otherwise <checkout>/.jax_cache."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import json, jax, jax.numpy as jnp
from telomeri_tpu.utils.compile_cache import enable_compile_cache
d = enable_compile_cache()
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(7.0)).block_until_ready()
print(json.dumps({"dir": d, "config": jax.config.jax_compilation_cache_dir}))
"""


def _probe(env_extra: dict, unset=()) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in unset}
    env.update(JAX_PLATFORMS="cpu", **env_extra)
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_cache_lands_in_jax_compilation_cache_dir_when_set(tmp_path):
    cache = tmp_path / "xla_cache"
    got = _probe({"JAX_COMPILATION_CACHE_DIR": str(cache),
                  # cache even this tiny program, so the test sees an entry
                  "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
                  "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"})
    assert got == {"dir": str(cache), "config": str(cache)}
    assert any(cache.iterdir()), "no compiled program written to the cache"


def test_cache_defaults_to_checkout_dir_when_unset():
    from telomeri_tpu.utils.compile_cache import CHECKOUT_CACHE_DIR

    want = os.path.join(ROOT, ".jax_cache")
    assert CHECKOUT_CACHE_DIR == want
    got = _probe({}, unset=("JAX_COMPILATION_CACHE_DIR",))
    assert got == {"dir": want, "config": want}
    assert os.path.isdir(want)
