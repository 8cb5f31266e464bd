"""Split-complex f64 operator: parity with the complex128 operator."""

import numpy as np
import jax.numpy as jnp

from fdtd2d import constants
from fdtd2d.ops.helmholtz import make_operator
from fdtd2d.ops.splitc import (
    Split, make_operator_f64, f64_operator_for, split_from_numpy,
    split_to_complex, snorm,
)


def _scene(N=96):
    rng = np.random.default_rng(3)
    eps = np.full((N, N), constants.EPSILON_0)
    eps[30:60, 20:50] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    x = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    return eps, mu, x


def test_f64_apply_matches_c128_operator():
    N, dx, omega = 96, 1e-3, 17e9
    eps, mu, x = _scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=20,
                       dtype=jnp.complex128)
    want = np.asarray(op.apply(jnp.asarray(x)))

    op64 = make_operator_f64(eps, mu, dx, dx, omega, pml_thickness=20)
    got = op64.apply(split_from_numpy(x))
    gotz = np.asarray(got.re) + 1j * np.asarray(got.im)
    scale = np.abs(want).max()
    assert np.abs(gotz - want).max() / scale < 1e-13


def test_f64_operator_for_roundtrip():
    """Rebuilding from a c64 operator carries f32-rounded parameters (eps,
    inv_mu, inv_2dx are stored f32), so parity with the exact c128 operator
    is limited to ~f32 eps; drivers that need full f64 accuracy build from
    the original scene arrays via make_operator_f64 instead."""
    N, dx, omega = 96, 1e-3, 17e9
    eps, mu, x = _scene(N)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=20,
                       dtype=jnp.complex64)
    op64 = f64_operator_for(op)
    want = np.asarray(make_operator(eps, mu, dx, dx, omega, pml_thickness=20,
                                    dtype=jnp.complex128).apply(jnp.asarray(x)))
    got = op64.apply(split_from_numpy(x))
    gotz = np.asarray(got.re) + 1j * np.asarray(got.im)
    assert np.abs(gotz - want).max() / np.abs(want).max() < 1e-6


def test_run_fdfd_refined_beats_c64_floor():
    """run_fdfd(refine_target=...) pushes the TRUE residual far below what a
    raw complex64 solve attains, using c64 inner solves only."""
    from fdtd2d import constants
    from fdtd2d.fdfd.solver import run_fdfd

    N, dx, omega = 128, 1e-3, 17e9
    eps = np.full((N, N), constants.EPSILON_0)
    eps[40:80, 30:70] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    source = np.zeros((N, N)); source[N // 2, N // 2] = 10.0

    out = run_fdfd(eps, mu, dx, dx, omega, source, pml_thickness=20,
                   dtype=jnp.complex64, tol=1e-5, maxiter=400,
                   refine_target=1e-9)
    # x64_residual describes the f64 iterate; relative_residual describes
    # the returned c64 downcast (floored by the downcast itself ~5e-5)
    assert float(out.x64_residual) < 1e-9
    assert float(out.relative_residual) < 5e-5
    assert bool(out.converged)

    # independent f64 residual check
    op64 = make_operator_f64(eps, mu, dx, dx, omega, pml_thickness=20)
    x = split_from_numpy(np.asarray(jnp.real(out.x))
                         + 1j * np.asarray(jnp.imag(out.x)))
    b = split_from_numpy(-1j * omega * source)
    rel = float(snorm(op64.residual(b, x))) / float(snorm(b))
    assert rel < 5e-5  # c64 representation floor of the returned field


def test_split_helpers():
    z = np.array([[1.0 + 2.0j, -3.0j]])
    s = split_from_numpy(z)
    # snorm factors out max|.| for overflow safety (see
    # test_snorm_overflow_safe), so equality holds to rounding, not bitwise
    assert np.isclose(float(snorm(s)), np.linalg.norm(z), rtol=1e-14)
    back = split_to_complex(s, jnp.complex64)
    assert np.allclose(np.asarray(jnp.real(back)) + 1j * np.asarray(jnp.imag(back)), z)

def test_snorm_overflow_safe():
    """snorm must not overflow for entries whose SQUARES exceed the dtype
    range. Where f64 is emulated as f32 pairs (f32 exponent range ~1e38),
    an FDFD right-hand side with -1j*omega applied twice (~3e20; squares
    ~8e40) turned every refinement trace to NaN — found driving
    DirectSolver.solve on an accelerator. On CPU the same bug
    reproduces at ~1e200 (squares past the true f64 range)."""
    from fdtd2d.ops.splitc import Split, snorm, snorm_batched

    big = np.full((4, 4), 3.0e200)
    s = Split(jnp.asarray(big), jnp.asarray(big))
    expected = 3.0e200 * np.sqrt(2.0 * 16)
    assert np.isfinite(float(snorm(s)))
    assert abs(float(snorm(s)) / expected - 1.0) < 1e-12

    sb = Split(jnp.asarray(big[None]), jnp.asarray(big[None]))
    nb = np.asarray(snorm_batched(sb))
    assert np.isfinite(nb).all() and abs(nb[0] / expected - 1.0) < 1e-12

    # zero norm stays zero (no 0/0)
    z = Split(jnp.zeros((2, 2)), jnp.zeros((2, 2)))
    assert float(snorm(z)) == 0.0
    zb = Split(jnp.zeros((1, 2, 2)), jnp.zeros((1, 2, 2)))
    assert float(np.asarray(snorm_batched(zb))[0]) == 0.0
