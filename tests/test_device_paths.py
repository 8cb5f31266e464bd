"""No hidden fallbacks: the smoke test refuses a host without a GPU, no
backend reaches an interpret mode, and the compile cache goes where the
environment or the checkout says."""

import inspect
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu_host():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout, proc.stdout
    assert "no GPU found" in proc.stderr, proc.stderr


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
@pytest.mark.parametrize("backend", ["auto", "jax", "kstep"])
def test_resolve_backend_never_interprets(platform, backend):
    """Every backend is a compiled path: the XLA step or the CUDA kernel,
    which has no interpret mode; no driver takes an ``interpret`` flag."""
    import importlib

    from fdtd2d.ops import kstep

    sim = importlib.import_module("fdtd2d.fdtd.simulate")

    got = sim.resolve_backend(backend, (4096, 4096), platform=platform)
    assert got in ("jax", "kstep")
    assert got == "kstep" or platform != "gpu" or backend == "jax"
    if backend == "auto" and platform != "gpu":
        assert got == "jax"
    for fn in (sim._advance, kstep.fdtd_multistep_kstep, kstep._sweep_cuda,
               kstep.sweep_reference):
        assert "interpret" not in inspect.signature(fn).parameters


def test_cache_honours_jax_compilation_cache_dir():
    from fdtd2d.utils.cache import resolve_cache_dir

    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where", "FDTD2D_CACHE_DIR": "0"}
    assert resolve_cache_dir(env) == "/some/where"


def test_cache_default_is_fixed_inside_checkout():
    from fdtd2d.utils.cache import DEFAULT_DIR, resolve_cache_dir

    assert resolve_cache_dir({}) == DEFAULT_DIR
    assert DEFAULT_DIR == os.path.join(REPO, ".cache", "xla")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".cache/" in f.read().split()
    assert resolve_cache_dir({"FDTD2D_CACHE_DIR": "0"}) is None


def test_kstep_library_builds_inside_checkout(monkeypatch):
    """The kernel's build goes to the git-ignored cache of the checkout and
    is named by the source's hash; without nvcc it fails loudly."""
    from fdtd2d.ops import kstep

    monkeypatch.setattr(kstep.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-toolkit"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kstep.build_library()


def test_kstep_kernel_refuses_float64():
    """The CUDA kernel is float32 only: other dtypes raise before any
    build or launch instead of being cast silently."""
    import jax.numpy as jnp

    from fdtd2d.ops import kstep

    f = jnp.zeros((64, 64), jnp.float64)
    with pytest.raises(TypeError, match="float32"):
        kstep._sweep_cuda(f, f, f, f, f, jnp.zeros(3, jnp.float64),
                          jnp.zeros(5, jnp.int32), halo=4, nsteps=4, row0=0,
                          row1=64, kind=0)

