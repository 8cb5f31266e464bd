"""Adjoint-solve VJP vs dense-solve autodiff oracle.

The custom_vjp in fdtd2d/fdfd/autodiff.py must produce the same gradients
as differentiating straight through ``jnp.linalg.solve`` on the densified
operator (which JAX knows how to do exactly).
"""

import numpy as np
import jax
import jax.numpy as jnp

from fdtd2d import constants
from fdtd2d.ops.helmholtz import make_operator
from fdtd2d.fdfd.autodiff import solve_helmholtz_differentiable

N, DX, OMEGA, PML = 24, 1e-3, 17e9, 6


def _dense_A(eps, mu):
    """Densify the matrix-free operator column by column."""
    op = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=PML, dtype=jnp.complex128)
    eye = jnp.eye(N * N, dtype=jnp.complex128)
    return jax.vmap(lambda col: op(col))(eye).T


def _scene():
    rng = np.random.default_rng(5)
    eps = constants.EPSILON_0 * (1.0 + rng.random((N, N)))
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N)); src[N // 2, N // 2] = 1.0
    b = jnp.asarray(-1j * OMEGA * src, jnp.complex128)
    return jnp.asarray(eps), jnp.asarray(mu), b


def _fdm_M():
    """Preconditioner built once from the concrete scene (outside any trace)."""
    from fdtd2d.ops.fdm import fdm_preconditioner_for

    eps, mu, _ = _scene()
    op = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=PML, dtype=jnp.complex128)
    return fdm_preconditioner_for(op)


_M = _fdm_M()


def _loss_via_custom(eps, mu, b):
    op = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=PML, dtype=jnp.complex128)
    x = solve_helmholtz_differentiable(op, b, preconditioner=_M, tol=1e-12, maxiter=200)
    return jnp.mean(jnp.abs(x) ** 2) * 1e-10  # scale to O(1)


def _loss_via_dense(eps, mu, b):
    op = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=PML, dtype=jnp.complex128)
    eye = jnp.eye(N * N, dtype=jnp.complex128)
    A = jax.vmap(op)(eye).T
    x = jnp.linalg.solve(A, b.ravel()).reshape(N, N)
    return jnp.mean(jnp.abs(x) ** 2) * 1e-10


def test_primal_matches_dense_solve():
    eps, mu, b = _scene()
    assert np.isclose(float(_loss_via_custom(eps, mu, b)),
                      float(_loss_via_dense(eps, mu, b)), rtol=1e-8)


def test_eps_gradient_matches_dense_autodiff():
    eps, mu, b = _scene()
    g_custom = jax.grad(_loss_via_custom)(eps, mu, b)
    g_dense = jax.grad(_loss_via_dense)(eps, mu, b)
    scale = np.max(np.abs(np.asarray(g_dense)))
    err = np.max(np.abs(np.asarray(g_custom) - np.asarray(g_dense))) / scale
    assert err < 1e-6, f"eps gradient mismatch {err:.3e}"


def test_mu_gradient_matches_dense_autodiff():
    eps, mu, b = _scene()
    g_custom = jax.grad(_loss_via_custom, argnums=1)(eps, mu, b)
    g_dense = jax.grad(_loss_via_dense, argnums=1)(eps, mu, b)
    scale = np.max(np.abs(np.asarray(g_dense)))
    err = np.max(np.abs(np.asarray(g_custom) - np.asarray(g_dense))) / scale
    assert err < 1e-6, f"mu gradient mismatch {err:.3e}"


def test_source_gradient_matches_dense_autodiff():
    eps, mu, b = _scene()

    def f_custom(br):
        return _loss_via_custom(eps, mu, br + 0.5j * br)

    def f_dense(br):
        return _loss_via_dense(eps, mu, br + 0.5j * br)

    br = jnp.real(b)
    g_custom = jax.grad(f_custom)(br)
    g_dense = jax.grad(f_dense)(br)
    scale = np.max(np.abs(np.asarray(g_dense))) + 1e-30
    err = np.max(np.abs(np.asarray(g_custom) - np.asarray(g_dense))) / scale
    assert err < 1e-6, f"source gradient mismatch {err:.3e}"
