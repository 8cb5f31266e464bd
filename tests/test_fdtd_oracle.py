"""Golden-oracle chain, FDTD leg 1: NumPy oracle vs pure-JAX step.

Also validates the NumPy oracle itself against an independent, literally
sequential transcription of the reference's update semantics (loop-for-loop),
so the vectorized oracle is proven equivalent to the reference's in-place
loops (reference: python-src/main.py:12-76) without importing reference code.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from fdtd2d.fdtd.reference import numpy_step, numpy_simulate
from fdtd2d.fdtd.step import fdtd_step, precompute_coefficients
from fdtd2d.fdtd.simulate import simulate, FDTDConfig
from fdtd2d import constants


def _sequential_reference_step(Ez, Hx, Hy, eps, mu, dt, dx):
    """In-place sequential update with the reference's exact loop structure."""
    Ez, Hx, Hy = Ez.copy(), Hx.copy(), Hy.copy()
    Hx[:-1, :] -= (dt / (mu[:-1, :-1] * dx)) * (Ez[1:, :-1] - Ez[:-1, :-1])
    Hy[:, :-1] += (dt / (mu[:-1, :-1] * dx)) * (Ez[:-1, 1:] - Ez[:-1, :-1])

    Ez_prev = Ez.copy()
    dHy_dx = Hy[1:, 1:-1] - Hy[1:, :-2]
    dHx_dy = Hx[1:-1, 1:] - Hx[:-2, 1:]
    Ez[1:-1, 1:-1] += (dHy_dx - dHx_dy) * (dt / (eps[1:-1, 1:-1] * dx))

    c = 1 / np.sqrt(mu[0, 0] * eps[0, 0])
    coef = (c * dt - dx) / (c * dt + dx)
    for i in range(5):
        Ez[1:-1, i] = Ez_prev[1:-1, i + 1] + coef * (Ez[1:-1, i + 1] - Ez_prev[1:-1, i])
    for i in range(5):
        Ez[1:-1, -(i + 1)] = Ez_prev[1:-1, -(i + 2)] + coef * (
            Ez[1:-1, -(i + 2)] - Ez_prev[1:-1, -(i + 1)]
        )
    for i in range(5):
        Ez[i, 1:-1] = Ez_prev[i + 1, 1:-1] + coef * (Ez[i + 1, 1:-1] - Ez_prev[i, 1:-1])
    for i in range(5):
        Ez[-(i + 1), 1:-1] = Ez_prev[-(i + 2), 1:-1] + coef * (
            Ez[-(i + 2), 1:-1] - Ez_prev[-(i + 1), 1:-1]
        )
    for i in range(5):
        for j in range(5):
            Ez[i, j] = (Ez[i, j + 1] + Ez[i + 1, j]) / 2
            Ez[i, -j - 1] = (Ez[i, -j - 2] + Ez[i + 1, -j - 1]) / 2
            Ez[-i - 1, j] = (Ez[-i - 2, j] + Ez[-i - 1, j + 1]) / 2
            Ez[-i - 1, -j - 1] = (Ez[-i - 2, -j - 1] + Ez[-i - 1, -j - 2]) / 2
    return Ez, Hx, Hy


def _random_state(rng, rows, cols):
    Ez = rng.standard_normal((rows, cols))
    Hx = rng.standard_normal((rows, cols - 1))
    Hy = rng.standard_normal((rows - 1, cols))
    eps = constants.EPSILON_0 * (1.0 + 2.0 * rng.random((rows, cols)))
    mu = np.full((rows, cols), constants.MU_0)
    return Ez, Hx, Hy, eps, mu


DT, DX = 5e-14, 1e-4


def test_vectorized_oracle_matches_sequential_semantics():
    rng = np.random.default_rng(0)
    Ez, Hx, Hy, eps, mu = _random_state(rng, 48, 64)
    for _ in range(3):
        a = numpy_step(Ez, Hx, Hy, eps, mu, DT, DX)
        b = _sequential_reference_step(Ez, Hx, Hy, eps, mu, DT, DX)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        Ez, Hx, Hy = a


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_jax_step_matches_numpy_oracle(dtype):
    rng = np.random.default_rng(1)
    Ez, Hx, Hy, eps, mu = _random_state(rng, 40, 56)
    ce, ch, coef = precompute_coefficients(eps, mu, DT, DX, dtype)
    jE, jHx, jHy = jnp.asarray(Ez, dtype), jnp.asarray(Hx, dtype), jnp.asarray(Hy, dtype)
    for _ in range(5):
        Ez, Hx, Hy = numpy_step(Ez, Hx, Hy, eps, mu, DT, DX)
        jE, jHx, jHy = fdtd_step(jE, jHx, jHy, ce, ch, coef)
    tol = 1e-12 if dtype == jnp.float64 else 1e-5
    scale = np.max(np.abs(Ez))
    assert np.max(np.abs(np.asarray(jE) - Ez)) / scale < tol


def test_full_rollout_fidelity_vs_oracle():
    """200-step point-source rollout: <=1e-5 relative field error (f32)."""
    rows = cols = 96
    eps = np.full((rows, cols), constants.EPSILON_0)
    eps[30:60, 30:40] *= 4.0
    mu = np.full((rows, cols), constants.MU_0)
    nsteps, fc = 200, 30e9

    ref = numpy_simulate(eps, mu, DT, DX, nsteps, (rows // 2, cols // 2), fc)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=nsteps, source_xy=(rows // 2, cols // 2),
                     source_fc=fc, dtype=jnp.float32, backend="jax")
    (Ez, _, _), _ = simulate(eps, mu, cfg)
    err = np.max(np.abs(np.asarray(Ez, np.float64) - ref)) / np.max(np.abs(ref))
    assert err < 1e-5, f"relative field error {err:.3e}"


def test_snapshot_frames_match_streamed_rollout():
    rows = cols = 64
    eps = np.full((rows, cols), constants.EPSILON_0)
    mu = np.full((rows, cols), constants.MU_0)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=100, source_xy=(32, 32), source_fc=30e9,
                     nframes=10, backend="jax")
    (Ez, _, _), snaps = simulate(eps, mu, cfg)
    assert snaps.shape == (10, rows, cols)
    np.testing.assert_allclose(np.asarray(snaps[-1]), np.asarray(Ez), rtol=0, atol=0)

    ref = numpy_simulate(eps, mu, DT, DX, 50, (32, 32), 30e9)
    mid = np.asarray(snaps[4], np.float64)
    assert np.max(np.abs(mid - ref)) / np.max(np.abs(ref)) < 1e-5


def test_simulate_batched_matches_per_scene():
    from fdtd2d.fdtd.simulate import simulate_batched

    rows = cols = 48
    eps1 = np.full((rows, cols), constants.EPSILON_0)
    eps2 = eps1.copy(); eps2[10:20, 10:20] *= 3.0
    mu = np.full((rows, cols), constants.MU_0)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=60, source_xy=(24, 24), source_fc=30e9,
                     backend="jax")
    (Ezb, _, _), _ = simulate_batched(np.stack([eps1, eps2]),
                                      np.stack([mu, mu]), cfg,
                                      sources_xy=[(24, 24), (20, 28)])
    ref1 = numpy_simulate(eps1, mu, DT, DX, 60, (24, 24), 30e9)
    ref2 = numpy_simulate(eps2, mu, DT, DX, 60, (20, 28), 30e9)
    for got, ref in zip(np.asarray(Ezb, np.float64), (ref1, ref2)):
        assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5


def test_simulate_batched_no_retrace():
    """Repeated sweeps with the same shapes/static config must reuse one
    compilation — even when dt/dx/fc change value (they are traced args)."""
    from fdtd2d.fdtd.simulate import simulate_batched, _simulate_batched_core

    rows = cols = 32
    eps = np.full((2, rows, cols), constants.EPSILON_0)
    mu = np.full((2, rows, cols), constants.MU_0)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=4, source_xy=(16, 16), source_fc=30e9,
                     backend="jax")
    simulate_batched(eps, mu, cfg)
    n0 = _simulate_batched_core._cache_size()
    simulate_batched(eps * 1.001, mu, cfg)  # new data, same shapes
    import dataclasses as _dc
    simulate_batched(eps, mu, _dc.replace(cfg, dt=DT * 0.5, source_fc=20e9))
    assert _simulate_batched_core._cache_size() == n0
