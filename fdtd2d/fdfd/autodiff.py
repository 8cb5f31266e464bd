"""Differentiable FDFD solve via implicit-function-theorem adjoint.

The reference's inverse-design workload differentiates through a sparse
direct solve that was never implemented (reference: python-src/inverse_design.py
imports the stub fdfd_jax.solve_linear). Here the solve is a matrix-free
Krylov iteration and the VJP is the adjoint system — one extra solve with the
same operator (A is complex symmetric, A^T = A, so the adjoint solve reuses
the forward solver and preconditioner verbatim) instead of unrolling the
iteration through AD.

For x = A(eps, 1/mu)^{-1} b and incoming cotangent g (JAX's vjp convention
is the pure transpose of the linearized map, with no conjugation):

    y      = A^{-T} g = A^{-1} g             (adjoint solve; A^T = A)
    b_bar  = y
    eps_bar = omega^2 Re(x * y)              (dA/deps = -omega^2 I per cell)
    invmu_bar = -sum_axes Re(K((1/s) x) * K((1/s) y))

PML stretch factors and omega are treated as non-differentiable structure.
All formulas are verified against dense ``jnp.linalg.solve`` autodiff in
tests/test_fdfd_autodiff.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from fdtd2d.ops.helmholtz import HelmholtzOperator, _dcol, _drow
from fdtd2d.fdfd.solver import _solve_core, resolve_preconditioner


@partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7))
def _solve(op: HelmholtzOperator, b, M, x0, method, builtin_pc, tol, maxiter):
    return _solve_core(op, b, M, method=method, builtin_pc=builtin_pc,
                       tol=tol, maxiter=maxiter, restart=40, x0=x0).x


def _solve_fwd(op, b, M, x0, method, builtin_pc, tol, maxiter):
    x = _solve(op, b, M, x0, method, builtin_pc, tol, maxiter)
    return x, (op, M, x)


def _solve_bwd(method, builtin_pc, tol, maxiter, residuals, g):
    op, M, x = residuals
    # JAX's vjp convention is the pure transpose (no conjugation): for
    # x = A^{-1} b, b_bar = A^{-T} g = A^{-1} g (A is complex symmetric).
    y = _solve_core(op, g, M, method=method, builtin_pc=builtin_pc,
                    tol=tol, maxiter=maxiter, restart=40).x

    b_bar = y
    eps_bar = (op.omega**2) * jnp.real(x * y)

    isc = op.inv_s_col[None, :]
    isr = op.inv_s_row[:, None]
    kx_c = _dcol(x * isc, op.inv_2dx)
    ky_c = _dcol(y * isc, op.inv_2dx)
    kx_r = _drow(x * isr, op.inv_2dy)
    ky_r = _drow(y * isr, op.inv_2dy)
    invmu_bar = -jnp.real(kx_c * ky_c + kx_r * ky_r)

    op_bar = HelmholtzOperator(
        eps=eps_bar.astype(op.eps.dtype),
        inv_mu=invmu_bar.astype(op.inv_mu.dtype),
        inv_s_row=jnp.zeros_like(op.inv_s_row),
        inv_s_col=jnp.zeros_like(op.inv_s_col),
        omega=jnp.zeros_like(op.omega),
        inv_2dx=jnp.zeros_like(op.inv_2dx),
        inv_2dy=jnp.zeros_like(op.inv_2dy),
        pml_thickness=op.pml_thickness,
        sigma_max=op.sigma_max,
        m=op.m,
    )
    M_bar = jax.tree.map(jnp.zeros_like, M)
    # x0 carries zero cotangent: at convergence the solution is independent
    # of the warm start (same IFT argument that justifies not unrolling)
    return op_bar, b_bar.reshape(op.shape), M_bar, jnp.zeros_like(g)


_solve.defvjp(_solve_fwd, _solve_bwd)


def solve_helmholtz_differentiable(op: HelmholtzOperator, b, *,
                                   method: str = "fgmres",
                                   preconditioner="fdm",
                                   tol: float = 1e-6,
                                   maxiter: int = 2000,
                                   x0=None) -> jax.Array:
    """Differentiable x = A^{-1} b; grads flow to op.eps, op.inv_mu, and b.

    With ``preconditioner="fdm"`` this must be called outside jit (host-side
    factor build); pass a prebuilt FDMPreconditioner when tracing.

    ``x0``: optional warm start (e.g. the previous optimization step's
    field — designs move slowly, so late-optimization solves start within
    1e-2..1e-3 of the answer and FGMRES skips most of its iterations). The
    warm start receives a zero cotangent.
    """
    b = b.reshape(op.shape).astype(op.dtype)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    else:
        # canonicalize like b BEFORE entering the custom_vjp: the bwd rule
        # returns zeros_like(g) (solution shape/dtype) as the x0 cotangent,
        # which only matches the caller's aval if the reshape/cast happen
        # out here where AD can transpose them
        x0 = x0.reshape(op.shape).astype(op.dtype)
    M, builtin = resolve_preconditioner(op, preconditioner)
    return _solve(op, b, M, x0, method, builtin, tol, maxiter)
