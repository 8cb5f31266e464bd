"""C8 sparse-layer contract tests (the reference's test_jax.py +
test_jax_fdfd.py obligations, reimplemented against our CSR layer)."""

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import jax
import jax.numpy as jnp
import pytest

from fdtd2d.ops.sparse import (
    CSR, _diags, _kron, _sp_matmul, _sp_add, _spsolve, from_scipy,
    make_A_jax, solve_linear, sparse_solve,
)


def test_diags_matches_scipy():
    # reference test contract: _diags vs scipy.sparse.diags (test_jax.py:7-22)
    diagonals = [np.arange(1.0, 5.0), np.arange(1.0, 6.0), np.arange(1.0, 5.0)]
    offsets = [-1, 0, 1]
    want = sp.diags(diagonals, offsets, shape=(5, 5)).toarray()
    got = _diags([jnp.asarray(d) for d in diagonals], offsets, (5, 5))
    np.testing.assert_array_equal(np.asarray(got.todense()), want)


def test_diags_rectangular_and_scalar():
    want = sp.diags([2.0], [1], shape=(3, 5)).toarray()
    got = _diags([jnp.full(3, 2.0)], [1], (3, 5))
    np.testing.assert_array_equal(np.asarray(got.todense()), want)


def test_kron_matches_scipy():
    rng = np.random.default_rng(0)
    A = sp.random(6, 5, density=0.4, random_state=rng).tocsr()
    B = sp.random(4, 7, density=0.5, random_state=rng).tocsr()
    want = sp.kron(A, B).toarray()
    got = _kron(from_scipy(A), from_scipy(B))
    np.testing.assert_allclose(np.asarray(got.todense()), want, atol=1e-14)


def test_sp_matmul_matches_scipy():
    rng = np.random.default_rng(1)
    A = sp.random(8, 6, density=0.4, random_state=rng).tocsr()
    B = sp.random(6, 9, density=0.4, random_state=rng).tocsr()
    want = (A @ B).toarray()
    got = _sp_matmul(from_scipy(A), from_scipy(B))
    np.testing.assert_allclose(np.asarray(got.todense()), want, atol=1e-14)


def test_sp_add_and_transpose():
    rng = np.random.default_rng(2)
    A = sp.random(7, 7, density=0.3, random_state=rng).tocsr()
    B = sp.random(7, 7, density=0.3, random_state=rng).tocsr()
    got = _sp_add(from_scipy(A), from_scipy(B), alpha=2.0, beta=-3.0)
    np.testing.assert_allclose(np.asarray(got.todense()), (2 * A - 3 * B).toarray(),
                               atol=1e-14)
    np.testing.assert_allclose(np.asarray(from_scipy(A).T.todense()), A.T.toarray(),
                               atol=1e-14)


def test_spsolve_matches_scipy():
    # reference test contract: _spsolve vs scipy (test_jax.py:67-85)
    rng = np.random.default_rng(3)
    A = (sp.random(30, 30, density=0.2, random_state=rng)
         + sp.eye(30) * 5.0).tocsr()
    b = rng.standard_normal(30)
    want = spla.spsolve(A.tocsc(), b)
    got = _spsolve(from_scipy(A), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10)


def test_spsolve_gradient_matches_dense():
    rng = np.random.default_rng(4)
    A = (sp.random(12, 12, density=0.35, random_state=rng) + sp.eye(12) * 4.0).tocsr()
    Ac = from_scipy(A)
    b = jnp.asarray(rng.standard_normal(12))

    def loss_sparse(data, b):
        M = CSR(data, Ac.indices, Ac.indptr, Ac.shape)
        x = _spsolve(M, b)
        return jnp.sum(x**2)

    def loss_dense(data, b):
        M = CSR(data, Ac.indices, Ac.indptr, Ac.shape).todense()
        x = jnp.linalg.solve(M, b)
        return jnp.sum(x**2)

    g_s = jax.grad(loss_sparse, argnums=(0, 1))(Ac.data, b)
    g_d = jax.grad(loss_dense, argnums=(0, 1))(Ac.data, b)
    for a, c in zip(g_s, g_d):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c), rtol=1e-8, atol=1e-10)


def test_make_A_jax_data_parity():
    """CSR .data elementwise equality with the scipy assembly — the exact
    contract of reference python-src/test_jax_fdfd.py:37-47 (1000^2 there;
    smaller here for CI time, same algebra)."""
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_fdfd_operator import scipy_make_A, _scene

    N, dx, omega = 40, 1e-3, 17e9
    eps, mu = _scene(N, seed=13)
    want = scipy_make_A(eps, mu, dx, dx, N, N, omega, pml_thickness=8)
    want.sort_indices()
    got = make_A_jax(jnp.asarray(eps), jnp.asarray(mu), dx, dx, N, N, omega,
                     pml_thickness=8)
    assert got.nnz == want.nnz, f"nnz mismatch: {got.nnz} vs {want.nnz}"
    np.testing.assert_array_equal(np.asarray(got.indices), want.indices)
    np.testing.assert_allclose(np.asarray(got.data), want.data, rtol=1e-6, atol=1e-6)


def test_solve_linear_and_sparse_solve():
    rng = np.random.default_rng(5)
    A = (sp.random(20, 20, density=0.3, random_state=rng) + sp.eye(20) * 3.0).tocsr()
    b = rng.standard_normal(20)
    want = spla.spsolve(A.tocsc(), b)
    Ac = from_scipy(A)
    np.testing.assert_allclose(np.asarray(solve_linear(Ac, b)), want, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sparse_solve(Ac, b, numerical=True)), want,
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sparse_solve(Ac, b, numerical=False)), want,
                               rtol=1e-8)
