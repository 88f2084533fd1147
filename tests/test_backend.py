"""The accelerator predicate, the device dispatch rule, the compilation
cache location and the trace counters."""

import os
import subprocess
import sys

import pytest

from ngsbits_tpu.ops.device_reduce import use_device
from ngsbits_tpu.utils import backend, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("value,expected", [
    (None, False),   # unset: follows the predicate (no accelerator here)
    ("1", True),     # explicit request: device formulations on any backend
    ("0", False),
])
def test_use_device_follows_device_engines(monkeypatch, value, expected):
    if value is None:
        monkeypatch.delenv("NGSBITS_DEVICE_ENGINES", raising=False)
    else:
        monkeypatch.setenv("NGSBITS_DEVICE_ENGINES", value)
    assert use_device() is expected


def test_unset_device_engines_follow_the_predicate(monkeypatch):
    monkeypatch.delenv("NGSBITS_DEVICE_ENGINES", raising=False)
    from ngsbits_tpu.ops import device_reduce
    monkeypatch.setattr(device_reduce, "has_accelerator", lambda: True)
    assert use_device()


def _fresh_python(code: str, env_extra: dict) -> str:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX_COMPILATION_CACHE")}
    env.update(env_extra, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def test_predicate_is_false_on_cpu_without_importing_jax():
    out = _fresh_python(
        "import sys; from ngsbits_tpu.utils.backend import has_accelerator; "
        "print(has_accelerator(), 'jax' in sys.modules)",
        {"JAX_PLATFORMS": "cpu"})
    assert out == "False False"


_CACHE_PROBE = (
    "from ngsbits_tpu.utils.backend import enable_compilation_cache\n"
    "d = enable_compilation_cache()\n"
    "import jax, jax.numpy as jnp, os\n"
    "jax.jit(lambda x: x * 3 + 1)(jnp.arange(5)).block_until_ready()\n"
    "print(d == jax.config.jax_compilation_cache_dir, len(os.listdir(d)) > 0, d)\n")


def test_compile_cache_uses_jax_compilation_cache_dir(tmp_path):
    d = tmp_path / "jc"
    out = _fresh_python(_CACHE_PROBE, {"JAX_PLATFORMS": "cpu",
                                       "JAX_COMPILATION_CACHE_DIR": str(d)})
    assert out == f"True True {d}"


def test_compile_cache_default_is_fixed_in_checkout(tmp_path):
    assert backend.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    # jax already imported: the settings go through jax.config
    out = _fresh_python(
        "import jax\n" + _CACHE_PROBE, {"JAX_PLATFORMS": "cpu"})
    assert out == f"True True {backend.DEFAULT_CACHE_DIR}"


def test_trace_counters():
    trace.reset_counters()
    trace.count("device.x")
    trace.count("device.x", 2)
    trace.count("mesh.shards.0")
    assert trace.counters() == {"device.x": 3, "mesh.shards.0": 1}
    trace.reset_counters()
    assert trace.counters() == {}
