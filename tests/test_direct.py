"""Sublattice block-Thomas direct solver vs the matrix-free operator.

Golden-oracle chain, direct leg: the 5-point coefficient extraction is
pinned against HelmholtzOperator.apply, the factored solve against scipy's
spsolve on the reference-assembled CSR matrix, and the c64+refine
production path on a genuinely hard scene (50% duty binary 5x contrast at
~lambda/8 — where the Krylov/Schwarz stack stalls; see fdfd/direct.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fdtd2d import constants
from fdtd2d.ops.helmholtz import make_operator
from fdtd2d.fdfd.direct import (
    DirectSolver, factor, five_point_coefficients, solve_direct,
    solve_factored,
)


def _hard_scene(N, seed=3):
    """Datagen-distribution binary 5x medium (the honest recipe pinned in
    core/scenes.py; fixed sigma=4 keeps features resolvable at test N)."""
    from fdtd2d.core.scenes import hard_binary_scene

    return hard_binary_scene(N, seed=seed, sigma=4.0, source_amp=10.0)


def test_five_point_matches_apply():
    N, dx, omega = 96, 1e-3, 17e9
    eps, mu, _ = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=16,
                       dtype=jnp.complex128)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((N, N))
                    + 1j * rng.standard_normal((N, N)))
    d, e, w, s, n = five_point_coefficients(op)

    xe = jnp.pad(x[:, 2:], ((0, 0), (0, 2)))
    xw = jnp.pad(x[:, :-2], ((0, 0), (2, 0)))
    xs = jnp.pad(x[2:, :], ((0, 2), (0, 0)))
    xn = jnp.pad(x[:-2, :], ((2, 0), (0, 0)))
    got = d * x + e * xe + w * xw + s * xs + n * xn
    want = op.apply(x)
    err = np.max(np.abs(np.asarray(got - want))) / np.max(np.abs(np.asarray(want)))
    assert err < 1e-12, f"five-point coefficients mismatch: {err:.2e}"


def test_direct_matches_spsolve():
    """Exact-solve parity with the reference's own method (scipy sparse LU
    on the assembled CSR, reference python-src/fdfd.py:112)."""
    import sys
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    import scipy.sparse.linalg as spla
    from test_fdfd_operator import scipy_make_A

    N, dx, omega = 96, 1e-3, 17e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=16,
                       dtype=jnp.complex128)
    b = jnp.asarray(-1j * omega * src)
    x = solve_direct(op, b)
    res = np.linalg.norm(np.asarray(op.apply(x) - b)) / np.linalg.norm(np.asarray(b))
    assert res < 1e-10, f"direct-solve residual: {res:.2e}"

    A = scipy_make_A(np.asarray(eps), np.asarray(mu), dx, dx, N, N,
                     float(omega), pml_thickness=16)
    want = spla.spsolve(A.tocsc(), np.asarray(b).ravel()).reshape(N, N)
    err = np.max(np.abs(np.asarray(x) - want)) / np.max(np.abs(want))
    assert err < 1e-8, f"direct vs spsolve: {err:.2e}"


def test_direct_factored_reuse():
    N, dx, omega = 64, 1e-3, 17e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=12,
                       dtype=jnp.complex128)
    f = factor(op)
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        b = jnp.asarray(rng.standard_normal((N, N))
                        + 1j * rng.standard_normal((N, N)))
        x = solve_factored(f, b)
        res = np.linalg.norm(np.asarray(op.apply(x) - b)) / np.linalg.norm(np.asarray(b))
        assert res < 1e-10, f"factored-solve residual (seed {seed}): {res:.2e}"


def test_direct_solver_c64_refined_hard_scene():
    """Production path: c64 factors + f64 refinement reach 1e-8 TRUE
    residual on the hard binary scene where the two-level tiled solver
    stalls around 0.3."""
    N, dx, omega = 160, 1e-3, 24e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=20,
                          dtype=jnp.complex64)
    x, trace = solver.solve(src, refine_target=1e-8)
    assert trace[-2] < 1e-8, f"refined true residual: {trace[-2]:.2e}"
    assert trace[-1] < 5e-5  # downcast floor of the returned c64 array

    # independent f64 residual of the split solution
    xs, tr2 = solver.solve(src, refine_target=1e-8, return_split=True)
    from fdtd2d.ops.splitc import snorm

    b = -1j * omega * np.asarray(src, np.complex128)
    from fdtd2d.ops.splitc import split_from_numpy

    r = solver.op64.residual(split_from_numpy(b), xs)
    rel = float(snorm(r)) / np.linalg.norm(b)
    assert rel < 1e-7, f"recomputed split residual: {rel:.2e}"


def test_direct_batched_vmap():
    """vmapped factor+solve over a scene batch (the datagen pattern)."""
    N, dx = 64, 1e-3
    ops = []
    bs = []
    for seed in range(3):
        eps, mu, src = _hard_scene(N, seed=seed)
        omega = 18e9 + 4e9 * seed
        ops.append(make_operator(eps, mu, dx, dx, omega, pml_thickness=12,
                                 dtype=jnp.complex128))
        bs.append(jnp.asarray(-1j * omega * src))
    ops_b = jax.tree.map(lambda *xs: jnp.stack(xs), *ops)
    b_b = jnp.stack(bs)
    xs = jax.vmap(lambda op, b: solve_factored(factor(op), b))(ops_b, b_b)
    for i, (op, b) in enumerate(zip(ops, bs)):
        res = np.linalg.norm(np.asarray(op.apply(xs[i]) - b)) / \
            np.linalg.norm(np.asarray(b))
        assert res < 1e-10, f"batched direct residual (scene {i}): {res:.2e}"


def test_direct_sharded_sublattices_match_single_device():
    """The four independent sublattices sharded over a 4-device mesh axis
    must reproduce the single-device factored solve exactly."""
    from fdtd2d.parallel.mesh import make_mesh
    from fdtd2d.parallel.direct_sharded import (
        factor_sharded, solve_factored_sharded)

    N, dx, omega = 96, 1e-3, 17e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=16,
                       dtype=jnp.complex128)
    b = jnp.asarray(-1j * omega * src)

    want = solve_direct(op, b)
    mesh = make_mesh((4,), axis_names=("s",))
    f = factor_sharded(op, mesh)
    got = solve_factored_sharded(f, b)
    err = np.max(np.abs(np.asarray(got - want)))
    scale = np.max(np.abs(np.asarray(want)))
    assert err / scale < 1e-12, f"sharded direct mismatch: {err/scale:.2e}"
    res = np.linalg.norm(np.asarray(op.apply(got) - b)) / \
        np.linalg.norm(np.asarray(b))
    assert res < 1e-10


def test_checkpointed_matches_full_factor():
    """Segment-checkpointed factor/solve (the past-the-memory-wall path)
    reproduces the store-all-W solve exactly."""
    from fdtd2d.fdfd.direct import factor_checkpointed, solve_checkpointed

    N, dx, omega = 64, 1e-3, 17e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=12,
                       dtype=jnp.complex128)
    b = jnp.asarray(-1j * omega * src)

    want = solve_direct(op, b)
    subs = factor_checkpointed(op, stride=8)
    got = solve_checkpointed(subs, b)
    err = np.max(np.abs(np.asarray(got - want)))
    scale = np.max(np.abs(np.asarray(want)))
    assert err / scale < 1e-12, f"checkpointed mismatch: {err/scale:.2e}"
    res = np.linalg.norm(np.asarray(op.apply(got) - b)) / \
        np.linalg.norm(np.asarray(b))
    assert res < 1e-10


def test_checkpointed_memory_shape():
    """The checkpointed factors store nseg+1 inverses per sublattice, not
    nr (the whole point)."""
    from fdtd2d.fdfd.direct import factor_checkpointed

    N, dx, omega = 64, 1e-3, 17e9
    eps, mu, _ = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=12,
                       dtype=jnp.complex128)
    subs = factor_checkpointed(op, stride=8)
    for fs in subs:
        assert fs.Wc.shape == (32 // 8, 32, 32)


def test_direct_sharded_checkpointed_matches_single_device():
    """Sharded + segment-checkpointed factors (both memory levers composed)
    reproduce the store-all single-device solve exactly."""
    from fdtd2d.parallel.mesh import make_mesh
    from fdtd2d.parallel.direct_sharded import (
        factor_sharded, solve_factored_sharded)

    N, dx, omega = 96, 1e-3, 17e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=16,
                       dtype=jnp.complex128)
    b = jnp.asarray(-1j * omega * src)

    want = solve_direct(op, b)
    mesh = make_mesh((4,), axis_names=("s",))
    f = factor_sharded(op, mesh, checkpointed=True, stride=8)
    # checkpoint storage per sublattice: nseg x nc x nc, nseg = 48/8
    assert f.stacked.Wc.shape == (4, 48 // 8, 48, 48)
    got = solve_factored_sharded(f, b)
    err = np.max(np.abs(np.asarray(got - want)))
    scale = np.max(np.abs(np.asarray(want)))
    assert err / scale < 1e-12, f"sharded ckpt mismatch: {err/scale:.2e}"
    res = np.linalg.norm(np.asarray(op.apply(got) - b)) / \
        np.linalg.norm(np.asarray(b))
    assert res < 1e-10


def test_direct_solver_growth_diagnostic_and_stall_warning():
    """The pivotless factorization exposes an element-growth diagnostic, and
    an unreachable refine_target surfaces as an explicit RuntimeWarning (not
    a silently-unconverged trace) citing it."""
    import warnings

    N, dx, omega = 96, 1e-3, 24e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=16,
                          dtype=jnp.complex64)
    assert np.isfinite(solver.factor_growth) and solver.factor_growth > 0
    assert solver.factor_growth < 1e6, solver.factor_growth  # healthy scene

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, trace = solver.solve(src, refine_target=1e-30)  # below f64 floor
    msgs = [str(w.message) for w in rec
            if issubclass(w.category, RuntimeWarning)]
    assert any("stalled" in m and "growth" in m for m in msgs), msgs
    assert trace[-2] < 1e-8  # the solve itself still refined to the floor


def test_compressed_factors_match_dense_and_refine():
    """HODLR-compressed factors (fdfd/compressed.py): the raw backsolve is
    accurate to the range-finder tolerance, the refined production path
    reaches the same true residuals as the dense store, and the store is
    actually smaller."""
    from fdtd2d.fdfd import compressed as comp
    from fdtd2d.ops.helmholtz import make_operator

    N, dx, omega = 160, 1e-3, 24e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=20,
                       dtype=jnp.complex64)
    b = jnp.asarray(-1j * omega * src, jnp.complex64)

    nc = N // 2
    L = comp.hodlr_plan(nc, leaf=16, rank=10)
    assert L >= 2, f"plan produced too-shallow hierarchy: L={L}"
    omegas = comp.make_test_matrices(nc, L, rank=10, dtype=jnp.complex64)
    f = comp.factor_compressed(op, omegas, L=L)

    # raw compressed backsolve: range-finder-accurate vs the dense store
    x_dense = solve_factored(factor(op), b)
    x_comp = comp.solve_compressed(f, b)
    rel = float(jnp.linalg.norm(x_comp - x_dense)
                / jnp.linalg.norm(x_dense))
    assert rel < 1e-2, f"compressed vs dense backsolve: {rel:.2e}"

    dense_bytes = 4 * (N // 2) * nc * nc * 8
    assert comp.compressed_bytes(f) < dense_bytes, (
        comp.compressed_bytes(f), dense_bytes)

    # production path: DirectSolver(compressed=True) + f64 refinement
    solver = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=20,
                          dtype=jnp.complex64, compressed=True, rank=10,
                          leaf=16)
    x, trace = solver.solve(src, refine_target=1e-8)
    assert trace[-2] < 1e-8, f"refined true residual: {trace[-2]:.2e}"
    assert trace[-1] < 5e-5  # downcast floor of the returned c64 array


def test_direct_sharded_compressed_matches_single_device():
    """HODLR-compressed factors sharded over the 4-device sublattice axis
    reproduce the single-device compressed backsolve and stay range-finder
    accurate against the exact solve."""
    from fdtd2d.fdfd import compressed as comp
    from fdtd2d.parallel.mesh import make_mesh
    from fdtd2d.parallel.direct_sharded import (
        factor_sharded, solve_factored_sharded)

    N, dx, omega = 160, 1e-3, 24e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=20,
                       dtype=jnp.complex64)
    b = jnp.asarray(-1j * omega * src, jnp.complex64)

    nc = N // 2
    L = comp.hodlr_plan(nc, leaf=16, rank=10)
    omegas = comp.make_test_matrices(nc, L, rank=10, dtype=jnp.complex64)
    want = comp.solve_compressed(
        comp.factor_compressed(op, omegas, L=L, q=1), b)

    mesh = make_mesh((4,), axis_names=("s",))
    f = factor_sharded(op, mesh, compressed=True, rank=10, leaf=16,
                       power_iters=1)
    got = solve_factored_sharded(f, b)
    rel = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
    assert rel < 1e-6, f"sharded compressed vs single-device: {rel:.2e}"

    exact = solve_direct(op, b.astype(jnp.complex128))
    rel2 = float(jnp.linalg.norm(got.astype(jnp.complex128) - exact)
                 / jnp.linalg.norm(exact))
    assert rel2 < 1e-2, f"sharded compressed vs exact: {rel2:.2e}"


def test_compressed_power_iteration_and_stacked_path():
    """q>0 subspace iterations sharpen the raw compressed backsolve (lower
    error vs the dense store at the same rank/storage), and the stacked
    single-device path (what DirectSolver uses on even grids — one batched
    scan over the 4 sublattices) matches the per-sublattice loop exactly."""
    from fdtd2d.fdfd import compressed as comp
    from fdtd2d.fdfd.direct import _solve_stacked, stack_coefficients

    N, dx, omega = 160, 1e-3, 24e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=20,
                       dtype=jnp.complex64)
    b = jnp.asarray(-1j * omega * src, jnp.complex64)
    x_dense = solve_factored(factor(op), b)

    nc = N // 2
    L = comp.hodlr_plan(nc, leaf=16, rank=10)
    omegas = comp.make_test_matrices(nc, L, rank=10, dtype=jnp.complex64)

    def err(q):
        x = comp.solve_compressed(
            comp.factor_compressed(op, omegas, L=L, q=q), b)
        return float(jnp.linalg.norm(x - x_dense) / jnp.linalg.norm(x_dense))

    e0, e1 = err(0), err(1)
    assert e1 < e0, f"power iteration did not sharpen: q=0 {e0:.2e} vs q=1 {e1:.2e}"
    assert e1 < 3e-3, f"q=1 compressed backsolve too loose: {e1:.2e}"

    # stacked path == loop path at the same q (bit-identical scans modulo
    # batched-vs-loop QR, which share the algorithm)
    f_loop = comp.factor_compressed(op, omegas, L=L, q=1)
    x_loop = comp.solve_compressed(f_loop, b)
    f_st = comp.factor_compressed_stacked(stack_coefficients(op), omegas,
                                          L=L, q=1)
    x_st = _solve_stacked(f_st, b)
    rel = float(jnp.linalg.norm(x_st - x_loop) / jnp.linalg.norm(x_loop))
    assert rel < 1e-6, f"stacked vs loop compressed solve: {rel:.2e}"

    # stacked dense path (the DirectSolver default on even grids)
    from fdtd2d.fdfd.direct import factor_stacked, solve_stacked

    x_stacked_dense = solve_stacked(factor_stacked(op), b)
    rel2 = float(jnp.linalg.norm(x_stacked_dense - x_dense)
                 / jnp.linalg.norm(x_dense))
    assert rel2 < 1e-6, f"stacked vs loop dense solve: {rel2:.2e}"


def test_solve_batched_matches_single_rhs():
    """solve_batched (one factorization, many sources, joint refinement)
    matches per-source solve() fields and meets the target per sample —
    for both the stored-W and HODLR-compressed factor modes."""
    N, dx, omega = 64, 1e-3, 24e9
    eps, mu, src0 = _hard_scene(N)
    rng = np.random.default_rng(7)
    srcs = np.zeros((3, N, N), np.complex128)
    srcs[0] = np.asarray(src0)
    for i in (1, 2):
        r, c = rng.integers(16, N - 16, 2)
        srcs[i, r, c] = 1.0

    for kw in ({}, {"compressed": True, "rank": 8, "leaf": 16}):
        solver = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=12,
                              dtype=jnp.complex64, **kw)
        xb, per_sample, trace = solver.solve_batched(srcs,
                                                     refine_target=1e-8)
        assert xb.shape == (3, N, N)
        assert np.all(np.asarray(per_sample) < 1e-8), per_sample
        assert trace[-1] < 1e-8
        for i in range(3):
            xi, _ = solver.solve(srcs[i], refine_target=1e-8)
            num = np.linalg.norm(np.asarray(xb[i]) - np.asarray(xi))
            den = np.linalg.norm(np.asarray(xi))
            assert num / den < 1e-5, (kw, i, num / den)
