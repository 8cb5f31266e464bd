"""Mixed-precision iterative refinement for FDFD solves.

The complex64 Krylov solvers bottom out at a true-residual floor of roughly
``eps_f32 * ||A|| ||x|| / ||b||`` — measured ~2e-6 for the plain global solve
at 512^2 and far worse through deep preconditioner stacks. The residual is
a memory-bound stencil, for which float64 elementwise arithmetic costs
little more than f32, so refinement evaluates residuals with the
split-complex f64 operator
(fdtd2d/ops/splitc.py):

    r_k = b - A x_k               (split f64, on device)
    d_k ~= A^{-1} (r_k / ||r_k||)  (any complex64 inner solve)
    x_{k+1} = x_k + ||r_k|| d_k    (split f64)

Each round contracts the true residual by the inner solve's achieved relative
residual (classical IR: converges whenever the inner solve resolves at least
one digit), reaching f64-floor true residuals from c64-only inner solves.
The inner RHS is normalized so the c64 solver always sees O(1)-norm data.

This replaces the reference's reliance on float64 scipy spsolve accuracy
(reference: python-src/fdfd.py:112) with an on-device mixed-precision scheme.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fdtd2d.ops.splitc import (
    HelmholtzF64, Split, require_x64, saxpy, snorm, snorm_batched,
    split_from_complex, split_to_complex,
)


class RefineResult(NamedTuple):
    x: Split                 # split-complex f64 solution
    relative_residual: jax.Array   # true f64 relative residual
    rounds: int
    trace: List[float]       # true relative residual per round (incl. final)


def true_relative_residual(op64: HelmholtzF64, b: Split, x) -> float:
    """TRUE f64 relative residual ||b - A x|| / ||b|| of ANY iterate ``x``
    (a :class:`Split` pair or a complex array, e.g. the complex64 downcast of
    a refined solution — whose residual is floor-limited by the downcast to
    ~eps_f32 * ||x|| regardless of how far the f64 iterate was refined)."""
    require_x64()
    if not isinstance(x, Split):
        x = split_from_complex(x, jnp.float64)
    else:
        x = x.astype(jnp.float64)
    _, rn = _residual_step(op64, b, x)
    bn = float(snorm(b))
    return float(rn) / bn if bn else 0.0


from functools import partial


@partial(jax.jit, static_argnames=("inner_dtype",))
def _residual_step(op64: HelmholtzF64, b: Split, x: Split,
                   *, inner_dtype=jnp.complex64):
    """(r/||r|| as inner_dtype, ||r|| f64) — one fused f64 residual pass."""
    r = op64.residual(b, x)
    rn = snorm(r)
    safe = jnp.where(rn == 0, 1.0, rn)
    rc = split_to_complex(Split(r.re / safe, r.im / safe), inner_dtype)
    return rc, rn


@jax.jit
def _update(x: Split, rn, d) -> Split:
    """x + rn * d with the c64 correction d lifted to split f64."""
    ds = split_from_complex(d, jnp.float64)
    return saxpy(rn, ds, x)


def refine(
    op64: HelmholtzF64,
    b: Split,
    inner_solve: Callable[[jax.Array], jax.Array],
    *,
    target: float = 1e-9,
    max_rounds: int = 8,
    x0: Optional[Split] = None,
    inner_dtype=jnp.complex64,
) -> RefineResult:
    """Iteratively refine ``A x = b`` to ``target`` true relative residual.

    ``inner_solve``: any complex64 solver taking a unit-norm (Nx, Ny) c64
    RHS and returning an approximate correction (e.g. a jitted FDM- or
    RAS-preconditioned FGMRES). The outer loop is a short host loop — each
    round is one fused f64 residual kernel plus one inner solve, both jitted.

    Stops early when the residual stagnates (inner solve no longer
    contracting), so a mis-tuned inner never loops forever.
    """
    require_x64()
    Nx, Ny = op64.shape
    if x0 is None:
        z = jnp.zeros((Nx, Ny), jnp.float64)
        x = Split(z, z)
    else:
        x = x0
    bn = float(snorm(b))
    if bn == 0.0:
        return RefineResult(x, jnp.asarray(0.0), 0, [0.0])

    trace: List[float] = []
    prev = float("inf")
    rounds = 0
    for k in range(max_rounds):
        rc, rn = _residual_step(op64, b, x, inner_dtype=inner_dtype)
        rel = float(rn) / bn
        trace.append(rel)
        if rel <= target or rel >= 0.9 * prev:  # converged or stagnated
            break
        prev = rel
        d = inner_solve(rc)
        x = _update(x, rn, d)
        rounds = k + 1
    else:
        rc, rn = _residual_step(op64, b, x, inner_dtype=inner_dtype)
        trace.append(float(rn) / bn)
    return RefineResult(x, jnp.asarray(trace[-1]), rounds, trace)


class BatchRefineResult(NamedTuple):
    x: Split                       # (B, Nx, Ny) split-complex f64 solutions
    relative_residual: jax.Array   # (B,) true f64 relative residual each
    rounds: int
    trace: List[float]             # MAX-over-batch relative residual/round


@partial(jax.jit, static_argnames=("inner_dtype",))
def _residual_step_batched(op64: HelmholtzF64, b: Split, x: Split,
                           *, inner_dtype=jnp.complex64):
    """Batched twin of :func:`_residual_step`: fields are (B, Nx, Ny),
    norms are per-sample. One fused f64 pass for the whole batch."""
    r = jax.vmap(op64.residual)(b, x)
    rn = snorm_batched(r)
    safe = jnp.where(rn == 0, 1.0, rn)[:, None, None]
    rc = split_to_complex(Split(r.re / safe, r.im / safe), inner_dtype)
    return rc, rn


@jax.jit
def _update_batched(x: Split, rn, d) -> Split:
    ds = split_from_complex(d, jnp.float64)
    return saxpy(rn[:, None, None], ds, x)


def refine_batched(
    op64: HelmholtzF64,
    b: Split,
    inner_solve: Callable[[jax.Array], jax.Array],
    *,
    target: float = 1e-9,
    max_rounds: int = 8,
    inner_dtype=jnp.complex64,
) -> BatchRefineResult:
    """Refine a BATCH of right-hand sides ``A x_i = b_i`` jointly.

    ``b``: a :class:`Split` with (B, Nx, Ny) parts (same operator, many
    sources — the build-once/solve-many sweep pattern). ``inner_solve``
    must map a (B, Nx, Ny) c64 batch to corrections, e.g.
    ``jax.jit(jax.vmap(single_rhs_solve))``. The refinement loop runs until
    the WORST sample meets ``target`` (or the worst-case residual
    stagnates); per-round cost is one batched f64 residual kernel plus one
    batched inner solve, so the per-sample cost of a B-way sweep approaches
    the inner solve's marginal batched cost rather than B full solves."""
    require_x64()
    if b.re.ndim != 3:
        raise ValueError(f"refine_batched wants (B, Nx, Ny) parts, "
                         f"got {b.re.shape}")
    B = b.re.shape[0]
    z = jnp.zeros(b.re.shape, jnp.float64)
    x = Split(z, z)
    bn = snorm_batched(b)
    bn_safe = np.where(np.asarray(bn) == 0.0, 1.0, np.asarray(bn))

    trace: List[float] = []
    prev = float("inf")
    rounds = 0
    for k in range(max_rounds):
        rc, rn = _residual_step_batched(op64, b, x, inner_dtype=inner_dtype)
        rel = np.asarray(rn) / bn_safe
        worst = float(rel.max()) if B else 0.0
        trace.append(worst)
        if worst <= target or worst >= 0.9 * prev:
            break
        prev = worst
        d = inner_solve(rc)
        x = _update_batched(x, rn, d)
        rounds = k + 1
    else:
        _, rn = _residual_step_batched(op64, b, x, inner_dtype=inner_dtype)
        trace.append(float((np.asarray(rn) / bn_safe).max()) if B else 0.0)
    _, rn = _residual_step_batched(op64, b, x, inner_dtype=inner_dtype)
    rel = jnp.asarray(np.asarray(rn) / bn_safe)
    return BatchRefineResult(x, rel, rounds, trace)
