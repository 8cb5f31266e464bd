"""HPS nested-dissection direct solver (fdfd/hps.py).

Golden-oracle chain, HPS leg: plan invariants, sublattice solve vs scipy
spsolve on the symmetrized 5-point matrix, full-operator solve vs the
block-Thomas direct leg (itself spsolve-pinned in test_direct.py), and the
DirectSolver(hps=True) refined production path on the hard binary scene.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fdtd2d.ops.helmholtz import make_operator
from fdtd2d.fdfd.direct import five_point_coefficients, solve_direct
from fdtd2d.fdfd.hps import (
    build_plan, factor_bytes, hps_factor, hps_factor_sub, hps_solve,
    hps_solve_sub,
)


def _hard_scene(N, seed=3):
    from fdtd2d.core.scenes import hard_binary_scene

    return hard_binary_scene(N, seed=seed, sigma=4.0, source_amp=10.0)


def _sub_coeffs(N=64, omega=2e10, pml=8, seed=0, parity=(0, 0)):
    """(d, Ecol, Erow) complex128 coefficient arrays of one sublattice."""
    rng = np.random.default_rng(seed)
    eps = np.where(rng.standard_normal((N, N)) > 0, 5e-11, 1e-11)
    mu = np.full((N, N), 1.26e-6)
    op = make_operator(eps, mu, 1e-3, 1e-3, omega, pml_thickness=pml)
    d, e, w, s, n = [np.asarray(a, np.complex128)
                     for a in five_point_coefficients(op)]
    px, py = parity
    return d[px::2, py::2], e[px::2, py::2], s[px::2, py::2]


def _scipy_sub_matrix(d, Ecol, Erow):
    """Symmetrized sublattice 5-point CSR (one coefficient per edge — the
    matrix HPS factors; equals the true operator to f32 assembly rounding)."""
    import scipy.sparse as sp

    nr, nc = d.shape
    idx = np.arange(nr * nc).reshape(nr, nc)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.extend(r.ravel()); cols.extend(c.ravel()); vals.extend(v.ravel())

    add(idx, idx, d)
    add(idx[:, :-1], idx[:, 1:], Ecol[:, :-1])
    add(idx[:, 1:], idx[:, :-1], Ecol[:, :-1])
    add(idx[:-1, :], idx[1:, :], Erow[:-1, :])
    add(idx[1:, :], idx[:-1, :], Erow[:-1, :])
    return sp.csr_matrix((vals, (rows, cols)), shape=(nr * nc, nr * nc))


def test_plan_partitions_every_point_once():
    """Leaf interiors + per-level J sets + root skeleton tile the grid."""
    for nr, nc, m in ((32, 32, 8), (64, 32, 8), (48, 48, 12)):
        plan = build_plan(nr, nc, m)
        seen = np.zeros((nr, nc), np.int32)
        lf = plan.leaf
        lr, lc = lf.idx_I // m, lf.idx_I % m
        for (r0, c0) in lf.origins:
            seen[r0 + lr, c0 + lc] += 1
        for mp in plan.merges:
            for (r0, c0) in mp.origins:
                seen[r0 + mp.J_coords[:, 0], c0 + mp.J_coords[:, 1]] += 1
        seen[plan.root_coords[:, 0], plan.root_coords[:, 1]] += 1
        assert np.all(seen == 1), f"coverage broken for {(nr, nc, m)}"


def test_plan_rejects_bad_geometry():
    with pytest.raises(ValueError):
        build_plan(60, 60, 8)     # not divisible by leaf
    with pytest.raises(ValueError):
        build_plan(24, 24, 8)     # 3x3 box grid is not a power of two


def test_hps_sublattice_matches_spsolve():
    """Machine-precision agreement with scipy's sparse LU in complex128,
    including a rectangular-merge geometry and a larger leaf."""
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(1)
    for N, m, parity in ((32, 8, (0, 0)), (64, 8, (1, 0)), (64, 16, (0, 1))):
        d, Ecol, Erow = _sub_coeffs(N, parity=parity)
        nr, nc = d.shape
        plan = build_plan(nr, nc, m)
        f = hps_factor_sub(jnp.asarray(d), jnp.asarray(Ecol),
                           jnp.asarray(Erow), plan)
        b = rng.standard_normal((nr, nc)) + 1j * rng.standard_normal((nr, nc))
        x = np.asarray(hps_solve_sub(f, plan, jnp.asarray(b))).ravel()
        A = _scipy_sub_matrix(d, Ecol, Erow)
        want = spla.spsolve(A.tocsc(), b.ravel())
        err = np.linalg.norm(x - want) / np.linalg.norm(want)
        assert err < 1e-10, f"N={N} m={m}: {err:.2e}"


def test_hps_full_operator_matches_direct():
    """Full outrigger solve vs the block-Thomas leg at the c64 floor."""
    N, dx, omega = 64, 1e-3, 17e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=12)
    b = jnp.asarray((-1j * omega * np.asarray(src)).astype(np.complex64))
    f = hps_factor(op, m=8)
    x = hps_solve(f, b)
    res = np.linalg.norm(np.asarray(op.apply(x) - b)) / np.linalg.norm(
        np.asarray(b))
    assert res < 5e-5, f"HPS c64 residual: {res:.2e}"
    want = np.asarray(solve_direct(op, b))
    err = np.linalg.norm(np.asarray(x) - want) / np.linalg.norm(want)
    assert err < 5e-5, f"HPS vs block-Thomas: {err:.2e}"


def test_hps_factor_is_memory_lean():
    """Stored factors scale as O(N^2 log N), subcubic in N: measured bytes
    match the analytic plan prediction exactly, and the predicted ratio vs
    the stored-W wall 4*(N/2)^3*8 B grows past the N≈256 crossover
    (1.05x there; ~3.2x at 1024², ~5.6x at 2048², ~10x at 4096²)."""
    from fdtd2d.fdfd.hps import predicted_factor_bytes

    N = 256
    eps, mu, _ = _hard_scene(N)
    op = make_operator(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=24)
    f = hps_factor(op, m=8)
    assert factor_bytes(f) == predicted_factor_bytes(N, m=8)
    wall = lambda n: 4 * (n // 2) ** 3 * 8
    assert predicted_factor_bytes(1024) < wall(1024) / 3
    assert predicted_factor_bytes(2048) < wall(2048) / 5
    assert predicted_factor_bytes(4096) < wall(4096) / 10
    # doubling N grows HPS storage ~2^2 log-factor (subcubic), the wall 2^3
    growth = predicted_factor_bytes(2048) / predicted_factor_bytes(1024)
    assert growth < 5.0, f"HPS growth per doubling: {growth:.2f}"


def test_hps_solver_refined_hard_scene():
    """DirectSolver(hps=True): true f64 residual of the f64 iterate reaches
    the refine target on the hard binary scene."""
    from fdtd2d.fdfd.direct import DirectSolver

    N, dx, omega = 64, 1e-3, 17e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=12, hps=True)
    x64, trace = solver.solve(src, refine_target=1e-8, return_split=True)
    assert trace[-1] < 1e-8, f"refined residual: {trace[-1]:.2e}"
    # parity with the stored-W DirectSolver on the same scene
    ref = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=12)
    xr, _ = ref.solve(src, refine_target=1e-8, return_split=True)
    err = (np.linalg.norm(np.asarray(x64.re - xr.re))
           + np.linalg.norm(np.asarray(x64.im - xr.im)))
    scale = np.linalg.norm(np.asarray(xr.re)) + np.linalg.norm(
        np.asarray(xr.im))
    assert err / scale < 1e-6, f"HPS vs stored-W refined: {err/scale:.2e}"


def test_hps_batched_rhs_vmap():
    """vmap over RHS shares one set of factors (datagen-style reuse)."""
    N = 32
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=8)
    f = hps_factor(op, m=8)
    rng = np.random.default_rng(2)
    bs = jnp.asarray(rng.standard_normal((3, N, N))
                     + 1j * rng.standard_normal((3, N, N))).astype(
                         jnp.complex64)
    xs = jax.vmap(lambda b: hps_solve(f, b))(bs)
    for i in range(3):
        res = np.linalg.norm(np.asarray(op.apply(xs[i]) - bs[i]))
        res /= np.linalg.norm(np.asarray(bs[i]))
        assert res < 5e-5, f"batched RHS {i}: {res:.2e}"


def test_hps_warns_past_accuracy_wall(monkeypatch):
    """DirectSolver(hps=True) past the measured 1024^2 c64 wall must warn
    at construction — building a 2048^2 factorization
    only to find refinement stalling costs minutes on the chip. The
    factorization itself is stubbed out: the warning must fire BEFORE the
    expensive build."""
    import pytest

    import fdtd2d.fdfd.hps as hps_mod
    from fdtd2d import constants
    from fdtd2d.fdfd.direct import DirectSolver

    def stop(*a, **k):
        raise InterruptedError("factor reached")

    monkeypatch.setattr(hps_mod, "hps_factor", stop)
    N = 2048
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    with pytest.warns(RuntimeWarning, match="accuracy wall"):
        with pytest.raises(InterruptedError):
            DirectSolver(eps, mu, 1e-3, 1e-3, 17e9, hps=True, hps_leaf=8)
