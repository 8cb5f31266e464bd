"""The K-step CUDA kernel against its plain-JAX reference, on the card.

Marked ``gpu``: it needs an NVIDIA GPU and skips elsewhere. Run it in a
process of its own on the card with ``FDTD2D_TEST_GPU=1`` (README, Quick
start), which keeps conftest from forcing the CPU."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    try:
        dev = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: the CUDA kernel has no interpret mode")
    return dev


@pytest.mark.parametrize("shape,nsteps,src,K,kind", [
    ((200, 300), 37, (3, 4), 8, "ricker"),
    ((200, 300), 37, (197, 296), 4, "ricker"),
    ((131, 250), 45, (65, 120), 12, "ricker"),
    ((300, 133), 29, (150, 66), 12, "sinusoidal"),
])
def test_kstep_kernel_matches_reference(gpu, shape, nsteps, src, K, kind):
    import jax
    import jax.numpy as jnp

    from fdtd2d import constants
    from fdtd2d.fdtd.step import precompute_coefficients
    from fdtd2d.ops.kstep import fdtd_multistep_kstep

    N, M = shape
    eps = np.full(shape, constants.EPSILON_0, np.float32)
    eps[N // 4 : N // 2, M // 4 : M // 3] *= 4.0
    mu = np.full(shape, constants.MU_0, np.float32)
    ce, ch, coef = precompute_coefficients(eps, mu, 5e-14, 1e-4, jnp.float32)
    zeros = tuple(jnp.zeros(s, jnp.float32) for s in ((N, M), (N, M - 1), (N - 1, M)))
    out = {}
    for impl in ("cuda", "reference"):
        f = jax.jit(lambda *z: fdtd_multistep_kstep(
            *z, ce, ch, coef, 5e-14, 30e9, src[0], src[1], nsteps, kind, 0,
            K=K, impl=impl))
        out[impl] = [np.asarray(a) for a in f(*zeros)]
    for got, want in zip(out["cuda"], out["reference"]):
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err < 1e-5, f"kernel vs reference: {err:.2e}"
