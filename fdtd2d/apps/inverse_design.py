"""Gradient-based photonics inverse design (frequency-response shaping).

Capability-equivalent of the reference workload (reference:
python-src/inverse_design.py:9-132): optimize a permittivity design region so
the mean |Ez| at a probe matches an ideal binary frequency response across a
band. The reference loops over frequencies in Python and differentiates
through a (missing) sparse direct solve, un-jitted; here:

- per-frequency operators + FDM preconditioners are built once (host side)
  and stacked into batched pytrees,
- the multi-frequency forward pass is one ``vmap`` over the adjoint-
  differentiable Krylov solve (fdtd2d/fdfd/autodiff.py),
- the whole loss-and-grad step is jitted; each gradient costs one extra
  (adjoint) solve per frequency instead of unrolling the iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fdtd2d.ops.helmholtz import HelmholtzOperator, make_operator
from fdtd2d.ops.fdm import fdm_preconditioner_for
from fdtd2d.fdfd.autodiff import solve_helmholtz_differentiable


@dataclasses.dataclass(frozen=True)
class InverseDesignProblem:
    """Scene + objective. Slices are (row_slice, col_slice) index pairs."""

    eps_base: jax.Array            # (Nx, Ny) relative permittivity background
    mu: jax.Array                  # (Nx, Ny)
    source: jax.Array              # (Nx, Ny)
    omegas: np.ndarray             # (F,) concrete frequencies
    ideal_response: jax.Array      # (F,)
    design_region: Tuple[slice, slice]
    probe_region: Tuple[slice, slice]
    dx: float = 1.0
    dy: float = 1.0
    pml_thickness: int = 40
    tol: float = 1e-6
    maxiter: int = 400


def lowpass_problem(N: int = 250, n_freqs: int = 10,
                    band: Tuple[float, float] = (10e9, 17e9),
                    dx: float = 1e-3, tol: float = 1e-6,
                    maxiter: int = 400) -> InverseDesignProblem:
    """The reference's low-pass-filter scene (inverse_design.py:38-61),
    parameterized by grid size (the reference hardcodes 250) and frequency
    band. Physical geometry is held fixed at the 250 mm reference domain:
    indices scale with N while dx scales the cell, so (N=250, dx=1mm) and
    (N=832, dx=0.3mm) describe the same device at different resolutions.

    Geometry, objective, probe, and update rule follow the reference. The
    units are rescaled to SI (absolute eps/mu; the top band frequency must
    satisfy dx <= lambda/10): at the reference's literal parameters (dx=1,
    eps~1, omega~1e10..1e11) the field is evanescent by ~10 orders of
    magnitude and all responses/gradients underflow — its checked-in code
    cannot run (stub imports), so the degeneracy was never observable there.

    The reference's intended decade sweep (inverse_design.py:44: 10-100 GHz)
    is ``decade_lowpass_problem`` — it needs dx ~ 0.3 mm => N ~ 832 to
    resolve 100 GHz on the same physical domain.
    """
    from fdtd2d import constants

    s = N / 250.0  # index scale factor: keeps the physical geometry fixed

    def r(v):  # scale and round an index
        return int(round(v * s))

    c = 1.0 / np.sqrt(constants.EPSILON_0 * constants.MU_0)
    lam_min = c / band[1]
    assert dx <= lam_min / 10.0 + 1e-12, (
        f"dx={dx} too coarse for {band[1]:.3g} Hz (need <= {lam_min / 10:.3g})")

    eps_base = jnp.ones((N, N))
    eps_base = eps_base.at[r(100) : r(150), 0 : r(75)].set(3.0)
    eps_base = eps_base.at[r(100) : r(150), r(175) : N].set(3.0)
    source = jnp.zeros((N, N))
    source = source.at[r(110) : r(140), r(40)].set(3.0)
    return InverseDesignProblem(
        eps_base=eps_base * constants.EPSILON_0,
        mu=jnp.full((N, N), constants.MU_0),
        source=source,
        omegas=np.linspace(band[0], band[1], n_freqs),
        ideal_response=jnp.asarray([1.0] * (n_freqs // 2) + [0.0] * (n_freqs - n_freqs // 2)),
        design_region=(slice(r(75), r(175)), slice(r(75), r(175))),
        probe_region=(slice(r(110), r(140)), slice(r(210), r(210) + 1)),
        dx=dx,
        dy=dx,
        pml_thickness=min(40, max(8, N // 8)),
        tol=tol,
        maxiter=maxiter,
    )


def decade_lowpass_problem(N: int = 848, n_freqs: int = 10,
                           **kwargs) -> InverseDesignProblem:
    """The reference's full decade sweep (10-100 GHz, reference
    inverse_design.py:44-61) on a grid fine enough to resolve 100 GHz:
    dx <= lambda(100 GHz)/10 ~ 0.2998 mm on the same 250 mm domain
    => N >= 834 (default 848: dx = 0.2948 mm, 8-aligned for sharding)."""
    dx = 250e-3 / N
    return lowpass_problem(N=N, n_freqs=n_freqs, band=(10e9, 100e9), dx=dx,
                           **kwargs)


def _stack_ops(problem: InverseDesignProblem, dtype):
    """Build per-omega operators + FDM preconditioners, stacked over F."""
    ops, Ms = [], []
    for omega in problem.omegas:
        op = make_operator(problem.eps_base, problem.mu, problem.dx, problem.dy,
                           float(omega), pml_thickness=problem.pml_thickness,
                           dtype=dtype)
        ops.append(op)
        Ms.append(fdm_preconditioner_for(op))
    stack = lambda *xs: jnp.stack(xs)
    return jax.tree.map(stack, *ops), jax.tree.map(stack, *Ms)


def make_response_fn(problem: InverseDesignProblem, dtype=jnp.complex64):
    """Returns jitted ``responses(design) -> (F,)`` and ``loss(design)``.

    ``loss.value_and_grad(design, x0s=None)`` additionally returns the
    converged per-frequency fields as aux, so optimization loops can warm-
    start the next step's forward solves (``x0s`` (F, Nx, Ny) complex)."""
    ops, Ms = _stack_ops(problem, dtype)
    rs, cs = problem.design_region
    pr, pc = problem.probe_region
    ideal = problem.ideal_response
    F = len(problem.omegas)
    Nx, Ny = problem.eps_base.shape

    def one_freq(op: HelmholtzOperator, M, eps, b, x0):
        op = dataclasses.replace(op, eps=eps.astype(op.eps.dtype))
        x = solve_helmholtz_differentiable(op, b, preconditioner=M,
                                           tol=problem.tol,
                                           maxiter=problem.maxiter, x0=x0)
        return jnp.mean(jnp.abs(x)[pr, pc]), x

    @jax.jit
    def _responses(design, ops, Ms, x0s):
        # complex arrays enter as jit ARGUMENTS (closure-captured arrays
        # become HLO literals inlined into the program);
        # design lives in relative units in [1, 3] (reference clip bounds),
        # the scene stores absolute permittivity.
        from fdtd2d import constants

        eps = problem.eps_base.at[rs, cs].set(design * constants.EPSILON_0)
        # reference RHS convention: b = +1j * omega * source (inverse_design.py:16)
        bs = jax.vmap(lambda op: (1j * op.omega) * problem.source.astype(dtype))(ops)
        return jax.vmap(one_freq, in_axes=(0, 0, None, 0, 0))(
            ops, Ms, eps, bs, x0s)

    @jax.jit
    def _loss(design, ops, Ms, x0s):
        r, xs = _responses(design, ops, Ms, x0s)
        r = r / jnp.max(r)
        return jnp.mean((r - ideal) ** 2), xs

    _vag = jax.jit(jax.value_and_grad(_loss, has_aux=True))

    def _zeros_x0():
        # complex zeros assembled on device INSIDE jit would be fine, but as
        # an eager argument it must go through the cplx helpers
        from fdtd2d.ops.cplx import czeros

        return czeros((F, Nx, Ny), dtype)

    def responses(design, x0s=None):
        r, _ = _responses(design, ops, Ms,
                          _zeros_x0() if x0s is None else x0s)
        return r

    def loss(design, x0s=None):
        v, _ = _loss(design, ops, Ms, _zeros_x0() if x0s is None else x0s)
        return v

    def loss_and_grad(design, x0s=None):
        (v, xs), g = _vag(design, ops, Ms,
                          _zeros_x0() if x0s is None else x0s)
        return v, g, xs

    loss.value_and_grad = loss_and_grad
    return responses, loss


def optimize(problem: InverseDesignProblem, *, steps: int = 100, lr: float = 0.05,
             clip: Tuple[float, float] = (1.0, 3.0), dtype=jnp.complex64,
             design0=None, optimizer: str = "adam", log_every: int = 10,
             callback: Callable | None = None, opt_tol: float | None = 1e-4):
    """Projected first-order optimization of the design region.

    ``optimizer="gd"`` reproduces the reference's plain loop
    (inverse_design.py:85-104: design -= lr * grad, clip to bounds); the
    default Adam normalizes the highly problem-dependent gradient scale.

    ``opt_tol``: solver tolerance used INSIDE the optimization loop (the
    returned final responses always use ``problem.tol``). Gradient noise at
    1e-4 is far below the descent signal, and the FGMRES iteration count —
    the whole cost of a step — scales with the requested digits; this is
    the main wall-clock lever for the 848^2 decade sweep.
    """
    import optax

    loop_problem = problem
    if opt_tol is not None and opt_tol > problem.tol:
        loop_problem = dataclasses.replace(problem, tol=opt_tol)
    responses, loss = make_response_fn(loop_problem, dtype)
    rs, cs = problem.design_region
    shape = (rs.stop - rs.start, cs.stop - cs.start)
    # start at the interior of the box constraints (the reference starts at
    # the lower bound 1.0, where projected GD is pinned whenever the gradient
    # points outward — a midpoint start keeps every component free to move)
    design = (jnp.full(shape, 0.5 * (clip[0] + clip[1]))
              if design0 is None else jnp.asarray(design0))

    tx = optax.adam(lr) if optimizer == "adam" else optax.sgd(lr)
    opt_state = tx.init(design)
    grad_fn = loss.value_and_grad  # ops/Ms ride as jit arguments

    @jax.jit
    def update(design, opt_state, g):
        updates, opt_state = tx.update(g, opt_state, design)
        design = jnp.clip(design + updates, clip[0], clip[1])
        return design, opt_state

    history = []
    x0s = None
    for step in range(steps):
        value, g, xs = grad_fn(design, x0s)
        x0s = xs  # warm-start the next step's forward solves
        design, opt_state = update(design, opt_state, g)
        history.append(float(value))
        if callback is not None and (step % log_every == 0 or step == steps - 1):
            callback(step, float(value), design)
    # final responses at the problem's own (tight) tolerance
    responses_final = responses
    if loop_problem is not problem:
        responses_final, _ = make_response_fn(problem, dtype)
    return design, responses_final(design, x0s), history


def binarize(design, clip: Tuple[float, float] = (1.0, 3.0)):
    """Threshold a continuous design at the midpoint of the box constraints
    (the manufacturable endpoint: relative permittivity is either material
    lo or hi; the reference's gray designs were never thresholded)."""
    mid = 0.5 * (clip[0] + clip[1])
    return jnp.where(jnp.asarray(design) > mid, clip[1], clip[0])
