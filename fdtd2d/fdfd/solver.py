"""Iterative FDFD solvers: preconditioned BiCGSTAB/GMRES on the matrix-free
Helmholtz operator.

Replaces the reference's sparse-LU direct solve (scipy spsolve at
python-src/fdfd.py:112, ~7 s at 512^2 on CPU, superlinear memory from LU
fill-in) with Krylov iteration whose every step is a fused stencil apply —
the form an accelerator executes at memory-bandwidth speed and that scales to sharded
meshes (fdtd2d/parallel/).

Preconditioners:
- "dst": complex-shifted-Laplacian inverse, applied exactly in O(N^2 log N)
  via DST-I diagonalization of the constant-coefficient distance-2 stencil
  (the classic shifted-Laplacian Helmholtz preconditioner, here with an
  FFT-exact coarse inverse instead of multigrid cycles).
- "jacobi": diagonal scaling.
- None: raw Krylov.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from fdtd2d.ops.dst import dst2d
from fdtd2d.ops.helmholtz import HelmholtzOperator, make_operator


def shifted_laplacian_preconditioner(
    op: HelmholtzOperator, beta: complex = 1.0 - 0.5j
) -> Callable[[jax.Array], jax.Array]:
    """M^{-1} exactly inverting the constant-coefficient shifted operator.

    M = mean(1/mu) (L_c + L_r) - beta omega^2 mean(eps) I, where L = K K^T is
    the 1D distance-2 Laplacian built from the truncated central difference K.
    K is skew-symmetric tridiagonal Toeplitz(-a, 0, a), a = 1/(2d), whose
    exact eigendecomposition is K = V (2ia cos(theta_k)) V^{-1} with
    V = diag(i^j) S, S the DST-I matrix, theta_k = k pi/(n+1). Hence
    L = -K^2 = V (4 a^2 cos^2 theta_k) V^{-1} *including* the boundary
    truncation — the inverse below is exact for the homogenized operator, so
    preconditioner error comes only from medium heterogeneity and the PML.
    With S^2 = (n+1)/2 I, V^{-1} = (2/(n+1)) S diag(i^-j).
    """
    Nx, Ny = op.shape
    im_ref = jnp.mean(op.inv_mu)
    eps_ref = jnp.mean(op.eps)
    kr = jnp.arange(1, Nx + 1)
    kc = jnp.arange(1, Ny + 1)
    lam_r = 4.0 * op.inv_2dy**2 * jnp.cos(jnp.pi * kr / (Nx + 1)) ** 2
    lam_c = 4.0 * op.inv_2dx**2 * jnp.cos(jnp.pi * kc / (Ny + 1)) ** 2
    shift = jnp.asarray(beta, op.dtype) * (op.omega**2) * eps_ref
    denom = (im_ref * (lam_r[:, None] + lam_c[None, :])).astype(op.dtype) - shift

    ii = jnp.asarray(1j, op.dtype)
    mod_r = ii ** jnp.arange(Nx)        # i^j along rows
    mod_c = ii ** jnp.arange(Ny)        # i^j along cols
    w = mod_r[:, None] * mod_c[None, :]
    w_inv = jnp.conj(w)                  # i^{-j} = conj(i^j)
    norm = 4.0 / ((Nx + 1) * (Ny + 1))

    def minv(r: jax.Array) -> jax.Array:
        shape = r.shape
        r2 = r.reshape(Nx, Ny).astype(op.dtype)
        rhat = dst2d(r2 * w_inv) * norm      # V^{-1} r
        x = w * dst2d(rhat / denom)          # V xhat
        return x.astype(op.dtype).reshape(shape)

    return minv


def jacobi_preconditioner(op: HelmholtzOperator) -> Callable[[jax.Array], jax.Array]:
    d = op.diagonal()

    def minv(r: jax.Array) -> jax.Array:
        return (r.reshape(d.shape) / d).reshape(r.shape).astype(op.dtype)

    return minv


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SolveResult:
    x: jax.Array            # (Nx, Ny) complex field
    relative_residual: jax.Array
    converged: jax.Array
    iterations: jax.Array   # Krylov iterations (-1: the method reports none)


class RefinedSolveResult(NamedTuple):
    """Result of a refined solve (``run_fdfd(..., refine_target=...)``).

    ``x`` is the complex64 downcast of the refined iterate and
    ``relative_residual`` is the TRUE f64 residual OF THAT DOWNCAST ARRAY —
    the downcast alone floors it around eps_f32 * ||A|| ||x|| / ||b||
    (~5e-5 measured at 512^2), however far refinement pushed the f64
    iterate. Callers needing the full refined accuracy use ``x64`` (the
    split-complex f64 solution, residual ``x64_residual``)."""

    x: jax.Array                   # complex64 downcast field
    relative_residual: jax.Array   # true f64 residual of the downcast x
    converged: jax.Array           # did the f64 ITERATE meet refine_target
    x64: object                    # fdtd2d.ops.splitc.Split, f64
    x64_residual: jax.Array        # true f64 residual of the f64 iterate
    trace: tuple                   # per-round true residuals of the iterate


@partial(jax.jit, static_argnames=("method", "builtin_pc", "maxiter", "restart", "tol"))
def _solve_core(op, b, M, *, method, builtin_pc, tol, maxiter, restart,
                x0=None):
    Nx, Ny = op.shape
    b2 = b.reshape(Nx, Ny).astype(op.dtype)

    if builtin_pc == "dst":
        M = shifted_laplacian_preconditioner(op)
    elif builtin_pc == "jacobi":
        M = jacobi_preconditioner(op)

    matvec = op.apply
    x0c = None if x0 is None else x0.reshape(Nx, Ny).astype(op.dtype)
    iterations = jnp.asarray(-1, jnp.int32)
    if method == "fgmres":
        from fdtd2d.ops.krylov import fgmres

        out = fgmres(matvec, b2, M, restart=restart, maxiter=maxiter, tol=tol,
                     x0=x0c)
        x, iterations = out.x, out.iterations
    elif method == "bicgstab":
        x, _ = jax.scipy.sparse.linalg.bicgstab(
            matvec, b2, x0=x0c, tol=tol, maxiter=maxiter, M=M
        )
    elif method == "gmres":
        x, _ = jax.scipy.sparse.linalg.gmres(
            matvec, b2, x0=x0c, tol=tol, maxiter=maxiter, restart=restart,
            M=M, solve_method="batched",
        )
    else:
        raise ValueError(f"unknown method {method!r}")

    from fdtd2d.ops.cplx import cnorm

    res = cnorm(op.apply(x) - b2) / cnorm(b2)
    return SolveResult(x=x, relative_residual=res, converged=res < 10 * tol,
                       iterations=iterations)


def resolve_preconditioner(op: HelmholtzOperator, preconditioner):
    """Resolve a preconditioner spec to (M_pytree_or_None, builtin_name)."""
    if preconditioner == "fdm":
        from fdtd2d.ops.fdm import fdm_preconditioner_for

        return fdm_preconditioner_for(op), None
    if preconditioner in ("dst", "jacobi", None):
        return None, preconditioner
    return preconditioner, None  # already a callable pytree (e.g. FDMPreconditioner)


def solve_fdfd(
    op: HelmholtzOperator,
    b: jax.Array,
    *,
    method: str = "fgmres",
    preconditioner="fdm",
    tol: float = 1e-6,
    maxiter: int = 2000,
    restart: int = 40,
) -> SolveResult:
    """Solve A x = b. ``b`` may be (Nx, Ny) or flattened; returns (Nx, Ny) x.

    ``preconditioner``: "fdm" (default; exact uniform-medium UPML inverse via
    host-side 1D eigendecompositions — call from OUTSIDE jit, or pass a
    prebuilt :class:`~fdtd2d.ops.fdm.FDMPreconditioner`), "dst", "jacobi",
    None, or any callable pytree.
    """
    M, builtin = resolve_preconditioner(op, preconditioner)
    return _solve_core(op, b, M, method=method, builtin_pc=builtin,
                       tol=tol, maxiter=maxiter, restart=restart)


def run_fdfd(eps, mu, dx, dy, omega, source, *, pml_thickness: int = 40,
             sigma_max: float = 2.0, m: int = 3, rhs_scale=None,
             dtype=jnp.complex64, refine_target: float | None = None,
             max_refine_rounds: int = 8, **solve_kwargs) -> SolveResult:
    """End-to-end steady-state solve from scene arrays.

    ``rhs_scale`` defaults to ``-1j*omega`` (the physical TE convention, used
    by the reference's tiled solver and datagen, tiled_solver.py:57); the
    plain driver used ``omega`` and inverse design ``+1j*omega`` — pass those
    explicitly for driver parity.

    ``refine_target``: when set, the complex64 solve is wrapped in
    split-complex f64 iterative refinement (fdtd2d/fdfd/refine.py) and a
    :class:`RefinedSolveResult` is returned: ``relative_residual`` is the
    TRUE f64 residual of the returned (downcast) ``x`` — floor ~5e-5 from
    the downcast itself — and the fully-refined split-f64 solution rides
    along as ``x64`` with its own ``x64_residual``.
    """
    import numpy as np

    from fdtd2d.ops.cplx import to_device_complex

    op = make_operator(eps, mu, dx, dy, omega, pml_thickness, sigma_max, m, dtype)
    scale = (-1j * float(omega)) if rhs_scale is None else complex(rhs_scale)
    # host-side RHS assembly (see ops/cplx.py)
    b = to_device_complex(np.asarray(source, np.complex128) * scale, dtype)
    if refine_target is None:
        return solve_fdfd(op, b, **solve_kwargs)

    from fdtd2d.fdfd.refine import refine
    from fdtd2d.ops.splitc import (make_operator_f64, split_from_numpy,
                                       split_to_complex)

    M, builtin = resolve_preconditioner(op, solve_kwargs.pop("preconditioner",
                                                             "fdm"))

    def inner_solve(rhs):
        return solve_fdfd(op, rhs, preconditioner=M if M is not None else builtin,
                          **solve_kwargs).x

    op64 = make_operator_f64(eps, mu, dx, dy, float(omega), pml_thickness,
                             sigma_max, m)
    b64 = split_from_numpy(np.asarray(source, np.complex128) * scale)
    out = refine(op64, b64, inner_solve, target=refine_target,
                 max_rounds=max_refine_rounds, inner_dtype=dtype)
    x = split_to_complex(out.x, dtype)
    from fdtd2d.fdfd.refine import true_relative_residual

    return RefinedSolveResult(
        x=x, relative_residual=jnp.asarray(true_relative_residual(op64, b64, x)),
        converged=out.relative_residual < 10 * refine_target,
        x64=out.x, x64_residual=out.relative_residual, trace=tuple(out.trace))
