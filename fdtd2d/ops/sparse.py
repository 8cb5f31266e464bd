"""JAX sparse-CSR layer with scipy-parity semantics (the reference's C8).

The reference repo stubs this entire layer (reference: python-src/fdfd_jax.py:9-11
has ``make_A_jax`` with a ``...`` body, ``solve_linear`` missing though
imported at python-src/fdfd.py:8; python-src/utils.py:6-12 stubs
``sparse_solve``), while its tests pin the intended contract: ``_diags``,
``_kron``, ``_sp_matmul``, ``_spsolve`` matching scipy element-for-element
(python-src/test_jax.py), and ``make_A_jax(...).data`` equal to the scipy
assembly's ``.data`` (python-src/test_jax_fdfd.py:37-47).

Design: sparsity STRUCTURE is computed at trace time with scipy (host,
concrete indices — this also guarantees scipy-identical CSR layouts by
construction), while VALUES are traced jnp arrays (differentiable, jittable).
``_spsolve`` wraps scipy's sparse LU through ``pure_callback`` with a
``custom_vjp`` adjoint (transpose solve), which is exactly the layer the
reference's README describes but never shipped (README.md:99-107).

Note: the matrix-free path (fdtd2d/ops/helmholtz.py + fdfd/solver.py) is
the accelerator production path; this module exists for API parity, CPU
oracles, and small direct solves.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CSR:
    """CSR matrix: traced values + concrete structure arrays."""

    data: jax.Array
    indices: jax.Array   # concrete when built outside jit
    indptr: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    def _pattern(self) -> sp.csr_matrix:
        """Concrete scipy pattern (structure only, data=1)."""
        return sp.csr_matrix(
            (np.ones(self.nnz), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    def rows(self) -> np.ndarray:
        """Concrete per-entry row indices."""
        indptr = np.asarray(self.indptr)
        return np.repeat(np.arange(self.shape[0]), np.diff(indptr))

    def todense(self) -> jax.Array:
        out = jnp.zeros(self.shape, self.data.dtype)
        return out.at[self.rows(), np.asarray(self.indices)].add(self.data)

    def matvec(self, v: jax.Array) -> jax.Array:
        contrib = self.data * v[np.asarray(self.indices)]
        return jax.ops.segment_sum(contrib, self.rows(), num_segments=self.shape[0])

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix(
            (np.asarray(self.data), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    def __matmul__(self, other):
        if isinstance(other, CSR):
            return _sp_matmul(self, other)
        return self.matvec(other)

    @property
    def T(self) -> "CSR":
        pat = self._pattern()
        marked = sp.csr_matrix(
            (np.arange(self.nnz), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )
        t = marked.T.tocsr()
        t.sort_indices()
        return CSR(data=self.data[t.data.astype(np.int64)],
                   indices=jnp.asarray(t.indices), indptr=jnp.asarray(t.indptr),
                   shape=(self.shape[1], self.shape[0]))


def from_scipy(A) -> CSR:
    A = sp.csr_matrix(A)
    A.sort_indices()
    return CSR(data=jnp.asarray(A.data), indices=jnp.asarray(A.indices),
               indptr=jnp.asarray(A.indptr), shape=A.shape)


def _diags(diagonals, offsets, shape: Tuple[int, int]) -> CSR:
    """scipy.sparse.diags equivalent with traced diagonal values."""
    if np.isscalar(offsets):
        offsets = [offsets]
        diagonals = [diagonals]
    n, m = shape
    # symbolic: scipy with slot markers 1..nnz per diagonal, concatenated
    marker_diags, flat_vals = [], []
    slot = 1
    for d, off in zip(diagonals, offsets):
        L = min(n + min(off, 0), m - max(off, 0))
        d = jnp.atleast_1d(jnp.asarray(d))
        if d.ndim == 0 or d.shape[0] == 1:
            d = jnp.broadcast_to(jnp.reshape(d, (-1,))[0], (L,))
        assert d.shape[0] == L, f"diagonal length {d.shape[0]} != {L}"
        marker_diags.append(np.arange(slot, slot + L, dtype=np.float64))
        flat_vals.append(d)
        slot += L
    M = sp.diags(marker_diags, offsets, shape=shape).tocsr()
    M.sort_indices()
    perm = M.data.astype(np.int64) - 1
    vals = jnp.concatenate(flat_vals)[perm]
    return CSR(data=vals, indices=jnp.asarray(M.indices),
               indptr=jnp.asarray(M.indptr), shape=shape)


def _eye(n: int, dtype=jnp.float64) -> CSR:
    return _diags(jnp.ones(n, dtype), 0, (n, n))


def _kron(A: CSR, B: CSR) -> CSR:
    """Kronecker product via direct COO index algebra (canonical CSR layout;
    scipy's kron may keep explicit block zeros on dense-ish inputs, but dense
    round-trips — the reference's test contract — agree exactly)."""
    a_rows, a_cols = A.rows(), np.asarray(A.indices)
    b_rows, b_cols = B.rows(), np.asarray(B.indices)
    Bn, Bm = B.shape
    rows = (a_rows[:, None] * Bn + b_rows[None, :]).ravel()
    cols = (a_cols[:, None] * Bm + b_cols[None, :]).ravel()
    order = np.lexsort((cols, rows))
    shape = (A.shape[0] * Bn, A.shape[1] * Bm)
    vals = (A.data[:, None] * B.data[None, :]).reshape(-1)[jnp.asarray(order)]
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.add.at(indptr, rows[order] + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(data=vals, indices=jnp.asarray(cols[order]),
               indptr=jnp.asarray(indptr), shape=shape)


def _sp_matmul(A: CSR, B: CSR) -> CSR:
    """Sparse-sparse product with scipy's structural semantics."""
    assert A.shape[1] == B.shape[0]
    C_pat = (A._pattern() @ B._pattern()).tocsr()
    C_pat.sort_indices()
    C_rows = np.repeat(np.arange(C_pat.shape[0]), np.diff(C_pat.indptr))

    # enumerate contributing (slotA, slotB) pairs on the host
    a_rows = A.rows()
    a_cols = np.asarray(A.indices)
    b_indptr = np.asarray(B.indptr)
    b_cols = np.asarray(B.indices)
    counts = np.diff(b_indptr)[a_cols]              # B-row length per A entry
    sa = np.repeat(np.arange(A.nnz), counts)
    sb = np.concatenate([
        np.arange(b_indptr[k], b_indptr[k + 1]) for k in a_cols
    ]) if A.nnz else np.zeros(0, np.int64)
    out_i = np.repeat(a_rows, counts)
    out_j = b_cols[sb]
    # map (out_i, out_j) -> output slot via the pattern's CSR lookup
    lut = sp.csr_matrix(
        (np.arange(C_pat.nnz) + 1.0, C_pat.indices, C_pat.indptr), shape=C_pat.shape)
    out_slot = np.asarray(lut[out_i, out_j]).ravel().astype(np.int64) - 1

    vals = jax.ops.segment_sum(A.data[sa] * B.data[sb], jnp.asarray(out_slot),
                               num_segments=C_pat.nnz)
    return CSR(data=vals, indices=jnp.asarray(C_pat.indices),
               indptr=jnp.asarray(C_pat.indptr),
               shape=(A.shape[0], B.shape[1]))


def _sp_add(A: CSR, B: CSR, alpha=1.0, beta=1.0) -> CSR:
    """alpha*A + beta*B with scipy's union structure."""
    assert A.shape == B.shape
    S = (A._pattern() + B._pattern()).tocsr()
    S.sort_indices()
    lut = sp.csr_matrix((np.arange(S.nnz) + 1.0, S.indices, S.indptr), shape=S.shape)

    def slots(M: CSR):
        return np.asarray(lut[M.rows(), np.asarray(M.indices)]).ravel().astype(np.int64) - 1

    vals = jnp.zeros((S.nnz,), jnp.result_type(A.dtype, B.dtype))
    vals = vals.at[slots(A)].add(alpha * A.data)
    vals = vals.at[slots(B)].add(beta * B.data)
    return CSR(data=vals, indices=jnp.asarray(S.indices),
               indptr=jnp.asarray(S.indptr), shape=A.shape)


# ---------------------------------------------------------------------------
# Direct solve through scipy with adjoint VJP
# ---------------------------------------------------------------------------


def _host_spsolve(data, indices, indptr, b, shape, transpose=False):
    A = sp.csr_matrix((np.asarray(data), np.asarray(indices), np.asarray(indptr)),
                      shape=shape)
    if transpose:
        A = A.T
    from scipy.sparse.linalg import spsolve as scipy_spsolve

    return np.asarray(scipy_spsolve(A.tocsc(), np.asarray(b)))


def _spsolve_impl(A: CSR, b, transpose=False):
    dtype = jnp.result_type(A.dtype, b.dtype)
    out_shape = jax.ShapeDtypeStruct((A.shape[0],), dtype)
    return jax.pure_callback(
        lambda d, bb: _host_spsolve(d, A.indices, A.indptr, bb, A.shape, transpose)
        .astype(dtype),
        out_shape, A.data, b, vmap_method="sequential",
    )


@jax.custom_vjp
def _spsolve(A: CSR, b) -> jax.Array:
    """x = A^{-1} b via scipy sparse LU (host callback), adjoint-differentiable."""
    return _spsolve_impl(A, b)


def _spsolve_fwd(A, b):
    x = _spsolve_impl(A, b)
    return x, (A, x)


def _spsolve_bwd(res, g):
    A, x = res
    lam = _spsolve_impl(A, g, transpose=True)        # A^{-T} g (pure transpose)
    rows = jnp.asarray(A.rows())
    data_bar = -(lam[rows] * x[np.asarray(A.indices)])
    A_bar = CSR(data=data_bar.astype(A.dtype), indices=A.indices,
                indptr=A.indptr, shape=A.shape)
    return A_bar, lam.astype(g.dtype)


_spsolve.defvjp(_spsolve_fwd, _spsolve_bwd)


# ---------------------------------------------------------------------------
# Reference-contract entry points
# ---------------------------------------------------------------------------


def make_A_jax(eps, mu, dx, dy, Nx, Ny, omega, pml_thickness: int = 40,
               sigma_max: float = 2.0, m: int = 3) -> CSR:
    """Assembled UPML Helmholtz CSR, element-for-element equal to the scipy
    assembly (the parity contract of reference python-src/test_jax_fdfd.py).

    Mirrors reference python-src/fdfd.py:14-61 algebraically, with the
    symbolic structure from scipy and traced values.
    """
    from fdtd2d import constants
    from fdtd2d.ops.helmholtz import pml_sigma_profile

    eps = jnp.asarray(eps)
    mu = jnp.asarray(mu)
    cdtype = jnp.result_type(eps.dtype, jnp.complex64)

    sig_x = pml_sigma_profile(Nx, pml_thickness, sigma_max, m)
    sig_y = pml_sigma_profile(Ny, pml_thickness, sigma_max, m)
    s_x = 1.0 + 1j * np.tile(sig_x[None, :], (Ny, 1)) / (omega * constants.EPSILON_0)
    s_y = 1.0 + 1j * np.tile(sig_y[:, None], (1, Nx)) / (omega * constants.EPSILON_0)

    nn = Nx * Ny
    Dx = _diags([jnp.full(Nx - 1, -1.0), jnp.full(Nx - 1, 1.0)], [-1, 1], (Nx, Nx))
    Dx = CSR(Dx.data / (2 * dx), Dx.indices, Dx.indptr, Dx.shape)
    Dy = _diags([jnp.full(Ny - 1, -1.0), jnp.full(Ny - 1, 1.0)], [-1, 1], (Ny, Ny))
    Dy = CSR(Dy.data / (2 * dy), Dy.indices, Dy.indptr, Dy.shape)

    C_x = _kron(_eye(Ny), Dx)
    C_y = _kron(Dy, _eye(Nx))
    S_x = _diags(jnp.asarray(1.0 / s_x.flatten(), cdtype), 0, (nn, nn))
    S_y = _diags(jnp.asarray(1.0 / s_y.flatten(), cdtype), 0, (nn, nn))
    C_x = _sp_matmul(S_x, CSR(C_x.data.astype(cdtype), C_x.indices, C_x.indptr, C_x.shape))
    C_y = _sp_matmul(S_y, CSR(C_y.data.astype(cdtype), C_y.indices, C_y.indptr, C_y.shape))

    M_eps = _diags(eps.flatten().astype(cdtype), 0, (nn, nn))
    M_mu = _diags((1.0 / mu.flatten()).astype(cdtype), 0, (nn, nn))

    term_x = _sp_matmul(_sp_matmul(C_x, M_mu), C_x.T)
    term_y = _sp_matmul(_sp_matmul(C_y, M_mu), C_y.T)
    return _sp_add(_sp_add(term_x, term_y), M_eps, beta=-(omega**2))


def solve_linear(A, b) -> jax.Array:
    """Solve A x = b: direct sparse LU for CSR, preconditioned Krylov for
    matrix-free operators (reference contract: fdfd.py:8, inverse_design.py:1)."""
    from fdtd2d.ops.helmholtz import HelmholtzOperator

    if isinstance(A, CSR):
        return _spsolve(A, jnp.asarray(b))
    if isinstance(A, HelmholtzOperator):
        from fdtd2d.fdfd.solver import solve_fdfd

        return solve_fdfd(A, jnp.asarray(b)).x.ravel()
    raise TypeError(f"unsupported operator type {type(A)!r}")


def sparse_solve(A: CSR, b, numerical: bool = True) -> jax.Array:
    """Reference contract (utils.py:6-12): numerical -> scipy LU callback;
    analytic -> densify and solve with jnp (fully on-device, differentiable
    through standard autodiff)."""
    if numerical:
        return _spsolve(A, jnp.asarray(b))
    return jnp.linalg.solve(A.todense(), jnp.asarray(b))
