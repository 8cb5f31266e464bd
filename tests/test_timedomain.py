"""Frequency-locked time-domain FDFD solver (fdfd/timedomain.py).

The golden-oracle chain leg for this compute path: the wave run's steady
state must satisfy the SAME outrigger system that scipy_make_A assembles
(reference python-src/fdfd.py:14-61), and the refined solve must match
scipy spsolve on the full grid.
"""

import sys
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fdtd2d import constants
from fdtd2d.fdfd.timedomain import (TimeDomainSolver, WaveBundle,
                                        build_wave_bundle, wave_run,
                                        _apply_S, _psi0, _split_sub,
                                        _merge_sub)
from fdtd2d.ops.helmholtz import make_operator

sys.path.insert(0, str(pathlib.Path(__file__).parent))


def _scene(N, contrast=1.5, pml=16, seed=0):
    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3 : 2 * N // 3, N // 4 : N // 2] *= contrast
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N), np.complex128)
    src[N // 2, N // 2] = 1.0
    return eps, mu, src


def test_wave_steady_state_is_interior_and_band_exact():
    """One long-settled wave run satisfies the TRUE stretched operator to
    the f32 floor — interior (dispersion-corrected drive) AND PML band
    (trapezoidal filters exact at the drive)."""
    N, dx, omega, pml = 128, 1e-3, 30e9, 20
    eps, mu, src = _scene(N, pml=pml)
    b = jnp.asarray(-1j * omega * src, jnp.complex64)
    b = b / jnp.linalg.norm(b)
    s = TimeDomainSolver(eps, mu, dx, dx, omega, pml_thickness=pml,
                         transits=12.0)
    x = s.precondition(b)
    r = np.asarray(b - s.op.apply(x))
    rel = np.linalg.norm(r)
    assert rel < 5e-3, f"steady-state residual {rel:.2e}"
    # band-localized mismatch would show up as band >> interior; the
    # trapezoidal filters keep them the same order (the sponge
    # predecessor floored at band ~2e-1 with interior 1.7e-5)
    T = pml + 4
    mask = np.zeros((N, N), bool)
    mask[:T, :] = mask[-T:, :] = mask[:, :T] = mask[:, -T:] = True
    assert np.linalg.norm(r[mask]) < 10 * np.linalg.norm(r[~mask]) + 5e-3


def test_solve_matches_spsolve():
    """Full refined solve vs the reference's own method (scipy sparse LU
    on the assembled CSR, python-src/fdfd.py:112)."""
    import scipy.sparse.linalg as spla
    from test_fdfd_operator import scipy_make_A

    N, dx, omega, pml = 96, 1e-3, 30e9, 16
    eps, mu, src = _scene(N, pml=pml)
    s = TimeDomainSolver(eps, mu, dx, dx, omega, pml_thickness=pml,
                         transits=4.0)
    x, trace = s.solve(src, refine_target=1e-8)
    assert trace[-2] <= 1e-8, f"refine trace: {trace}"

    b = -1j * omega * src
    A = scipy_make_A(eps, mu, dx, dx, N, N, float(omega), pml_thickness=pml)
    want = spla.spsolve(A.tocsc(), b.ravel()).reshape(N, N)
    err = np.max(np.abs(np.asarray(x) - want)) / np.max(np.abs(want))
    assert err < 1e-5, f"timedomain vs spsolve: {err:.2e}"


def test_dense_and_separable_paths_agree():
    """The dense (general-mu) stepping path must reproduce the separable
    (constant-mu) fast path when mu happens to be uniform."""
    N, dx, omega, pml = 64, 1e-3, 30e9, 12
    eps, mu, src = _scene(N, pml=pml)
    b = jnp.asarray(-1j * omega * src, jnp.complex64)
    b = b / jnp.linalg.norm(b)
    bs = _split_sub(b)

    sep = build_wave_bundle(eps, mu, dx, dx, omega, pml_thickness=pml,
                            transits=3.0)
    assert not sep.dense
    # an infinitesimally perturbed mu forces the dense layout; the
    # coefficient difference is below f32 resolution
    mu2 = mu.copy()
    mu2[0, 0] *= 1.0 + 1e-13
    den = build_wave_bundle(eps, mu2, dx, dx, omega, pml_thickness=pml,
                            transits=3.0)
    assert den.dense
    xs = np.asarray(wave_run(sep, bs))
    xd = np.asarray(wave_run(den, bs))
    err = np.max(np.abs(xs - xd)) / np.max(np.abs(xs))
    assert err < 1e-4, f"dense vs separable: {err:.2e}"


@pytest.mark.slow
def test_update_operator_spectrum_is_stable():
    """No growing mode in the one-step update operator (the passivity
    argument for the trapezoidal filters, checked numerically). The
    rejected designs all failed here: complex-gain one-pole 1.0089,
    forward-Euler CPML 1.00018, drive-resonant biquad grew in-band."""
    N, dx, omega, pml = 16, 1e-3, 60e9, 4
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    bnd = build_wave_bundle(eps, mu, dx, dx, omega, pml_thickness=pml)
    nr = nc = N // 2
    t = bnd.t
    sc = (4, nr, 2 * t)
    sr = (4, 2 * t, nc)
    shapes = [(4, nr, nc), (4, nr, nc), sc, sr, sc, sr, sc, sr]
    sizes = [int(np.prod(s)) for s in shapes]
    D = sum(sizes)

    def unpack(v):
        out, o = [], 0
        for s, sz in zip(shapes, sizes):
            out.append(v[o : o + sz].reshape(s))
            o += sz
        return out

    hd = bnd.hd_r[:, :, None] + bnd.hd_c[:, None, :]

    @jax.jit
    def stepv(v):
        u, uprev, p1, p2, p3, p4, c5, c6 = unpack(v)
        su, new = _apply_S(bnd, u, uprev, (p1, p2, p3, p4, c5, c6))
        unew = (2.0 * u - (1.0 - hd) * uprev
                - bnd.inv_eps_dt2 * su) / (1.0 + hd)
        return jnp.concatenate([a.ravel() for a in (unew, u) + new])

    M = jax.vmap(stepv)(jnp.eye(D, dtype=jnp.complex64)).T
    ev = np.linalg.eigvals(np.asarray(M, np.complex128))
    assert np.abs(ev).max() <= 1.0 + 1e-7, np.abs(ev).max()


def test_solver_reports_honest_trace_and_warns_on_stall():
    """An undersized settling budget must warn, not silently return."""
    N, dx, omega, pml = 64, 1e-3, 30e9, 12
    eps, mu, src = _scene(N, pml=pml)
    s = TimeDomainSolver(eps, mu, dx, dx, omega, pml_thickness=pml,
                         steps_override=8)   # absurdly short run
    with pytest.warns(RuntimeWarning, match="time-domain solve stalled"):
        x, trace = s.solve(src, refine_target=1e-10, max_refine_rounds=3)
    assert np.all(np.isfinite(np.asarray(x)))


def test_chunked_wave_run_matches_single_dispatch():
    """wave_run_chunked splits the settle scan into bounded dispatches
    (no single dispatch holds the device for minutes) — it must be
    BIT-identical to the one-dispatch wave_run: same steps, same k
    indices, same filter-state threading."""
    from fdtd2d.fdfd.timedomain import wave_run_chunked

    N, dx, omega, pml = 64, 1e-3, 30e9, 12
    eps, mu, src = _scene(N, pml=pml)
    bnd = build_wave_bundle(eps, mu, dx, dx, omega, pml_thickness=pml,
                            transits=2.0)
    b_sub = _split_sub(jnp.asarray(-1j * omega * src, jnp.complex64))
    x_one = np.asarray(wave_run(bnd, b_sub))
    for seg in (17, 64, 10 ** 9):   # ragged remainder, even split, no-op
        x_chunk = np.asarray(wave_run_chunked(bnd, b_sub, seg))
        assert np.array_equal(x_one, x_chunk), seg


def test_solver_chunked_dispatch_path():
    """TimeDomainSolver with a small max_dispatch_steps must route through
    the chunked path and agree with the single-dispatch solver."""
    N, dx, omega, pml = 64, 1e-3, 30e9, 12
    eps, mu, src = _scene(N, pml=pml)
    kw = dict(pml_thickness=pml, transits=6.0)
    s1 = TimeDomainSolver(eps, mu, dx, dx, omega, **kw)
    s2 = TimeDomainSolver(eps, mu, dx, dx, omega, max_dispatch_steps=100,
                          **kw)
    assert s2.bundle.n_main > 100   # the chunked path is actually exercised
    x1, _ = s1.solve(src, refine_target=1e-5)
    x2, _ = s2.solve(src, refine_target=1e-5)
    err = np.max(np.abs(np.asarray(x1) - np.asarray(x2)))
    assert err / np.max(np.abs(np.asarray(x1))) < 1e-5, err
