"""Golden-oracle chain, FDFD leg: matrix-free operator vs scipy assembly.

The oracle is a test-local scipy transcription of the reference's UPML
Helmholtz assembly (reference: python-src/fdfd.py:14-61). The matrix-free
apply must reproduce its matvec to fp64 roundoff on square grids (the only
shape the reference's kron convention is self-consistent on).
"""

import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp
import pytest

from fdtd2d import constants
from fdtd2d.ops.helmholtz import make_operator, pml_sigma_profile
from fdtd2d.fdfd.solver import solve_fdfd, run_fdfd


def scipy_make_A(eps, mu, dx, dy, Nx, Ny, omega, pml_thickness=40, sigma_max=2, m=3):
    """Reference-equivalent sparse assembly (square-grid convention)."""
    sig_x = pml_sigma_profile(Nx, pml_thickness, sigma_max, m)
    sig_y = pml_sigma_profile(Ny, pml_thickness, sigma_max, m)
    s_x = 1 + 1j * np.tile(sig_x[None, :], (Ny, 1)) / (omega * constants.EPSILON_0)
    s_y = 1 + 1j * np.tile(sig_y[:, None], (1, Nx)) / (omega * constants.EPSILON_0)

    Dx = sp.diags([-1, 1], [-1, 1], shape=(Nx, Nx)) / (2 * dx)
    Dy = sp.diags([-1, 1], [-1, 1], shape=(Ny, Ny)) / (2 * dy)
    C_x = sp.kron(sp.eye(Ny), Dx)
    C_y = sp.kron(Dy, sp.eye(Nx))
    C_x = sp.diags(1 / s_x.flatten()) @ C_x
    C_y = sp.diags(1 / s_y.flatten()) @ C_y
    M_eps = sp.diags(eps.flatten())
    M_mu = sp.diags(1 / mu.flatten())
    return (C_x @ M_mu @ C_x.T + C_y @ M_mu @ C_y.T - omega**2 * M_eps).tocsr()


def _scene(N, seed=0):
    rng = np.random.default_rng(seed)
    eps = constants.EPSILON_0 * (1.0 + 2.0 * rng.random((N, N)))
    mu = np.full((N, N), constants.MU_0)
    return eps, mu


@pytest.mark.parametrize("pml", [0, 10])
def test_matrix_free_apply_matches_scipy_matvec(pml):
    N, dx, omega = 48, 1e-3, 17e9
    eps, mu = _scene(N)
    A = scipy_make_A(eps, mu, dx, dx, N, N, omega, pml_thickness=pml)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=pml, dtype=jnp.complex128)

    rng = np.random.default_rng(1)
    for _ in range(3):
        v = rng.standard_normal(N * N) + 1j * rng.standard_normal(N * N)
        want = A @ v
        got = np.asarray(op(jnp.asarray(v)))
        scale = np.max(np.abs(want))
        assert np.max(np.abs(got - want)) / scale < 1e-12


def test_operator_diagonal_matches_scipy():
    N, dx, omega = 32, 1e-3, 17e9
    eps, mu = _scene(N, seed=3)
    A = scipy_make_A(eps, mu, dx, dx, N, N, omega, pml_thickness=8)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=8, dtype=jnp.complex128)
    want = A.diagonal()
    got = np.asarray(op.diagonal()).ravel()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-12


@pytest.mark.parametrize("precond", ["fdm", "dst"])
def test_iterative_solve_matches_spsolve(precond):
    """Field parity vs the reference's direct sparse solve at 128^2."""
    import scipy.sparse.linalg as spla

    N, dx, omega = 128, 1e-3, 17e9
    eps, mu = _scene(N, seed=7)
    source = np.zeros((N, N))
    source[N // 2, N // 2] = 10.0
    b = (-1j * omega * source).flatten()

    A = scipy_make_A(eps, mu, dx, dx, N, N, omega, pml_thickness=20)
    want = spla.spsolve(A, b).reshape(N, N)

    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=20, dtype=jnp.complex128)
    maxiter = 200 if precond == "fdm" else 6000
    res = solve_fdfd(op, jnp.asarray(b), preconditioner=precond,
                     tol=1e-9, maxiter=maxiter, restart=120)
    got = np.asarray(res.x)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert float(res.relative_residual) < 1e-8
    assert err < 1e-5, f"field error {err:.3e}"


def test_fdm_preconditioner_one_cycle():
    """The FDM preconditioner must converge within one restart cycle even on
    a heterogeneous medium (iteration counts depend on contrast, not size)."""
    N, dx, omega = 96, 1e-3, 17e9
    eps, mu = _scene(N, seed=9)
    source = np.zeros((N, N)); source[40, 40] = 1.0
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=16, dtype=jnp.complex128)
    b = jnp.asarray(-1j * omega * source)

    res_pc = solve_fdfd(op, b, preconditioner="fdm", tol=1e-10, maxiter=40)
    assert float(res_pc.relative_residual) < 1e-10, (
        f"FDM-preconditioned solve stalled: {float(res_pc.relative_residual):.2e}"
    )


def test_run_fdfd_wrapper():
    N = 64
    eps, mu = _scene(N, seed=11)
    src = np.zeros((N, N)); src[32, 32] = 1.0
    res = run_fdfd(eps, mu, 1e-3, 1e-3, 17e9, src, pml_thickness=10,
                   dtype=jnp.complex128, tol=1e-8, maxiter=2000)
    assert res.x.shape == (N, N)
    assert float(res.relative_residual) < 1e-7
