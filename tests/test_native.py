"""Native C++ engine vs the NumPy oracle and the JAX operator."""

import numpy as np
import jax.numpy as jnp
import pytest

from fdtd2d import constants
from fdtd2d.fdtd.reference import numpy_step, numpy_simulate
from fdtd2d.ops.helmholtz import make_operator

native = pytest.importorskip("fdtd2d.native")

if not native.available():  # pragma: no cover
    pytest.skip("native toolchain unavailable", allow_module_level=True)

DT, DX = 5e-14, 1e-4


def test_native_step_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    rows, cols = 48, 64
    Ez = rng.standard_normal((rows, cols))
    Hx = rng.standard_normal((rows, cols - 1))
    Hy = rng.standard_normal((rows - 1, cols))
    eps = constants.EPSILON_0 * (1 + 2 * rng.random((rows, cols)))
    mu = np.full((rows, cols), constants.MU_0)

    nE, nHx, nHy = Ez.copy(), Hx.copy(), Hy.copy()
    for _ in range(3):
        Ez, Hx, Hy = numpy_step(Ez, Hx, Hy, eps, mu, DT, DX)
        nE, nHx, nHy = native.fdtd_step(nE, nHx, nHy, eps, mu, DT, DX)
    np.testing.assert_allclose(nE, Ez, rtol=0, atol=1e-14)
    np.testing.assert_allclose(nHx, Hx, rtol=0, atol=1e-14)
    np.testing.assert_allclose(nHy, Hy, rtol=0, atol=1e-14)


def test_native_rollout_matches_numpy_oracle():
    rows = cols = 64
    eps = np.full((rows, cols), constants.EPSILON_0)
    eps[20:40, 30:40] *= 3
    mu = np.full((rows, cols), constants.MU_0)
    want = numpy_simulate(eps, mu, DT, DX, 120, (32, 32), 30e9)
    got, _, _ = native.fdtd_run(eps, mu, DT, DX, 120, (32, 32), 30e9)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-12


def test_native_helmholtz_matvec_matches_jax():
    N, dx, omega = 40, 1e-3, 17e9
    rng = np.random.default_rng(1)
    eps = constants.EPSILON_0 * (1 + rng.random((N, N)))
    mu = np.full((N, N), constants.MU_0)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=8,
                       dtype=jnp.complex128)
    x = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    want = np.asarray(op.apply(jnp.asarray(x)))
    got = native.helmholtz_matvec(
        x, eps, mu, np.asarray(op.inv_s_row), np.asarray(op.inv_s_col),
        float(op.inv_2dx), float(op.inv_2dy), omega)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-13
