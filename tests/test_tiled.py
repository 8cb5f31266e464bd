"""Tiled Schwarz solver vs the global direct/iterative solve."""

import numpy as np
import jax.numpy as jnp
import pytest

from fdtd2d import constants
from fdtd2d.fdfd.tiled import run_fdfd_tiled, generate_patches, bfs_order
from fdtd2d.ops.helmholtz import make_operator
from fdtd2d.fdfd.solver import solve_fdfd


def _scene(N=160):
    eps = np.full((N, N), constants.EPSILON_0)
    eps[60:100, 40:70] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    source = np.zeros((N, N))
    source[N // 2, N // 2] = 10.0
    return eps, mu, source


def test_patch_generation_uniform_windows():
    origins = generate_patches(160, 160, patch_size=64, padding=16)
    W = 64 + 32
    assert all(0 <= x <= 160 - W and 0 <= y <= 160 - W for x, y in origins)
    # cores must cover the domain
    cover = np.zeros((160, 160), bool)
    for x0, y0 in origins:
        cover[x0 : x0 + W, y0 : y0 + W] = True
    assert cover.all()


def test_bfs_distances_source_outward():
    origins = generate_patches(160, 160, patch_size=64, padding=16)
    src = np.zeros((160, 160)); src[10, 10] = 1.0
    d = bfs_order(origins, 96, src, halo=8)
    assert (d == 0).any() and d.max() >= 1


@pytest.mark.slow
def test_tiled_krylov_matches_global_solve():
    """RAS-preconditioned global FGMRES converges to the true solution."""
    N, dx, omega = 160, 1e-3, 17e9
    eps, mu, source = _scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=40, dtype=jnp.complex128)
    want = np.asarray(solve_fdfd(op, jnp.asarray(-1j * omega * source, jnp.complex128),
                                 tol=1e-10, maxiter=300).x)

    got, trace = run_fdfd_tiled(
        eps, mu, dx, dx, omega, source, patch_size=64, padding=24,
        pml_thickness=10, mode="krylov", solver_tol=1e-8, solver_maxiter=120,
        inner_iters=15, global_pml_thickness=40, dtype=jnp.complex128,
        refine_target=None)
    err = np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))
    assert err < 1e-3, f"krylov tiled field error vs global solve: {err:.2e}"


def test_tiled_krylov_complex64_refined():
    """The PRODUCTION path: complex64 inner solves (the accelerator's dtype)
    + two-level Schwarz + f64 iterative refinement reach a true f64 residual
    far below the c64 rounding floor. One-level c64 RAS at production scale
    stalls around 0.7-0.8 (measured at 512^2); this test
    pins the fix at CI-viable size."""
    from fdtd2d.ops.splitc import make_operator_f64, split_from_numpy, snorm

    N, dx, omega = 160, 1e-3, 17e9
    eps, mu, source = _scene(N)

    got, trace = run_fdfd_tiled(
        eps, mu, dx, dx, omega, source, patch_size=64, padding=24,
        pml_thickness=10, mode="krylov", solver_tol=1e-5, solver_maxiter=60,
        inner_iters=15, global_pml_thickness=40, dtype=jnp.complex64,
        refine_target=1e-7)
    # trace = per-round residuals of the f64 ITERATE, then one final entry
    # for the RETURNED (c64-downcast) array
    assert trace[-2] < 1e-7, f"refined true residual: {trace[-2]:.2e}"

    # independently recompute the true residual in f64
    op64 = make_operator_f64(eps, mu, dx, dx, omega, pml_thickness=40)
    x = split_from_numpy(np.asarray(jnp.real(got)) + 1j * np.asarray(jnp.imag(got)))
    b = split_from_numpy(-1j * omega * source)
    r = op64.residual(b, x)
    rel = float(snorm(r)) / float(snorm(b))
    # x was rounded through c64 on return, so the recomputed residual sits at
    # the c64 representation floor rather than the refined f64 one — and the
    # trace's final entry must REPORT that downcast floor, not the discarded
    # iterate's residual
    assert rel < 5e-5, f"recomputed true residual: {rel:.2e}"
    np.testing.assert_allclose(trace[-1], rel, rtol=1e-6)

    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=40,
                       dtype=jnp.complex128)
    want = np.asarray(solve_fdfd(op, jnp.asarray(-1j * omega * source,
                                                 jnp.complex128),
                                 tol=1e-10, maxiter=300).x)
    err = np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))
    assert err < 1e-4, f"c64 krylov field error vs c128 global: {err:.2e}"


def test_pou_weights_partition_of_unity():
    """The PoU weights must sum to exactly 1 wherever any patch core covers
    (seam discontinuities in the blended correction put O(||A||*jump) spikes
    into A z — the measured 9x amplification this blending exists to kill)."""
    from fdtd2d.fdfd.tiled import pou_weights

    N, ps, pad, pml = 160, 64, 24, 10
    W = ps + 2 * pad
    origins = generate_patches(N, N, ps, pad)
    w = pou_weights(origins, W, N, N, pml, pad)
    assert w.min() >= 0.0 and w.max() <= 1.0
    total = np.zeros((N, N))
    for wp, (x0, y0) in zip(w, origins):
        total[x0 : x0 + W, y0 : y0 + W] += wp
    interior = total[pad:-pad, pad:-pad]
    np.testing.assert_allclose(interior, 1.0, atol=1e-12)


def test_fgmres_cost_granularity_is_the_restart_cycle():
    """fgmres always completes full restart cycles: maxiter < restart still
    runs `restart` Arnoldi iterations — callers wanting cheap inner solves
    must set restart=maxiter (pinned so the footgun stays documented)."""
    import jax

    from fdtd2d.ops.krylov import fgmres

    A = jnp.asarray(np.diag(np.linspace(1.0, 2.0, 16)))
    b = jnp.ones((16,))
    out = fgmres(lambda x: A @ x, b, restart=12, maxiter=5, tol=1e-30)
    assert int(out.iterations) == 12  # one full cycle, not 5


def test_tiled_solver_reuse_across_sources():
    """TiledSolver: one scene build, multiple sources — the production sweep
    pattern (per-call scene transfer can dominate one-shot solves)."""
    from fdtd2d.fdfd.tiled import TiledSolver

    N, dx, omega = 160, 1e-3, 17e9
    eps, mu, _ = _scene(N)
    solver = TiledSolver(eps, mu, dx, dx, omega, patch_size=64, padding=24,
                         pml_thickness=10, inner_iters=8)

    s1 = np.zeros((N, N)); s1[N // 2, N // 2] = 10.0
    s2 = np.zeros((N, N)); s2[N // 3, 2 * N // 3] = 5.0
    x1, t1 = solver.solve(s1, solver_tol=1e-5, solver_maxiter=60,
                          refine_target=1e-7)
    x2, t2 = solver.solve(s2, solver_tol=1e-5, solver_maxiter=60,
                          refine_target=1e-7)
    # t[-2] = f64 iterate residual; t[-1] = the returned downcast's residual
    assert t1[-2] < 1e-7 and t2[-2] < 1e-7
    assert t1[-1] < 5e-5 and t2[-1] < 5e-5
    d = np.abs(np.asarray(x1) - np.asarray(x2)).max()
    assert d > 0, "distinct sources must give distinct fields"


def test_tiled_adaptive_second_level():
    """The scene-level probe drops the ORAS patch level when the coarse FDM
    contraction is already strong and patches buy <30% — convergence is
    unchanged, per-iteration cost roughly halves. adaptive=False forces the
    full two-level application; both reach the refine target."""
    from fdtd2d.fdfd.tiled import TiledSolver

    N, dx, omega = 160, 1e-3, 17e9
    eps, mu, _ = _scene(N)
    src = np.zeros((N, N)); src[N // 2, N // 2] = 10.0

    solver = TiledSolver(eps, mu, dx, dx, omega, patch_size=64, padding=24,
                         pml_thickness=10)
    xa, ta = solver.solve(src, solver_tol=1e-5, solver_maxiter=60,
                          refine_target=1e-7)
    assert solver._patch_decision is not None      # probe ran
    cc, ct = solver._patch_probe
    assert 0 < cc < 1 and 0 < ct <= cc + 1e-6      # patches never hurt
    assert ta[-2] < 1e-7

    xf, tf = solver.solve(src, solver_tol=1e-5, solver_maxiter=60,
                          refine_target=1e-7, adaptive=False)
    assert tf[-2] < 1e-7
    rel = (np.linalg.norm(np.asarray(xa) - np.asarray(xf))
           / np.linalg.norm(np.asarray(xf)))
    assert rel < 1e-4, f"adaptive and forced solves disagree: {rel:.2e}"


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
@pytest.mark.slow
def test_tiled_stationary_modes_approximate(mode):
    """The stationary Schwarz sweeps (the reference's algorithm) converge to
    an approximate field — the reference validated this only by eyeballing
    plots (README.md:131-134); we bound the approximation numerically."""
    N, dx, omega = 160, 1e-3, 17e9
    eps, mu, source = _scene(N)

    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=20, dtype=jnp.complex128)
    want = np.asarray(solve_fdfd(op, jnp.asarray(-1j * omega * source, jnp.complex128),
                                 tol=1e-10, maxiter=200).x)

    got, deltas = run_fdfd_tiled(
        eps, mu, dx, dx, omega, source, patch_size=64, padding=24,
        pml_thickness=10, n_passes=10, relax=0.5, tol=1e-9,
        mode=mode, dtype=jnp.complex128, solver_tol=1e-9)
    got = np.asarray(got)

    pml = 24  # compare away from the global PML ring (local PMLs differ there)
    w = want[pml:-pml, pml:-pml]
    g = got[pml:-pml, pml:-pml]
    err = np.max(np.abs(g - w)) / np.max(np.abs(w))
    assert deltas[-1] < deltas[0], f"not converging: {deltas}"
    assert err < 0.4, f"tiled field error vs global solve: {err:.3f}"


def test_tiled_solver_restart_memory_default():
    """The default FGMRES restart is memory-aware: (2r+1)*N^2*8 B of basis
    clamps to ~6 GB (restart=60 at 4096^2 was a measured 16.8 GB OOM on a
    15.75 GB chip); explicit values are honored unclamped."""
    from fdtd2d.fdfd.tiled import TiledSolver

    N = 160
    eps, mu, _ = _scene(N)
    s = TiledSolver(eps, mu, 1e-3, 1e-3, 17e9, patch_size=64, padding=24)
    assert s.outer_restart == 60          # small grid: full default
    # the formula at 4096^2 resolves to min(60, 6e9 // (2*4096^2*8)) = 22
    assert min(60, max(4, int(6e9 / (2 * 4096**2 * 8)))) == 22
    s2 = TiledSolver(eps, mu, 1e-3, 1e-3, 17e9, patch_size=64, padding=24,
                     outer_restart=7)
    assert s2.outer_restart == 7
