"""Golden-oracle chain, FDTD leg 4: the temporally blocked (K-step) path.

The CUDA kernel itself has no interpret mode; it is compared with its plain
reference on the card (tests/test_kstep_gpu.py, chip_smoke.py). Here the
K-step driver runs the plain-JAX sweep with the kernel's contract
(fdtd2d/ops/kstep.py) against the float64 NumPy oracle, over the same
edge cases: several sweeps, a remainder sweep (nsteps % K != 0), sources
near tile and domain edges, row counts that are no tile multiple. The tile
plan, the layout conversion and the choice of kernel are plain Python and
are tested as they run on the card."""

import numpy as np
import jax.numpy as jnp
import pytest

from fdtd2d import constants
from fdtd2d.fdtd.reference import numpy_simulate
from fdtd2d.fdtd.step import precompute_coefficients
from fdtd2d.ops.kstep import (
    DEFAULT_K, SMEM_PER_BLOCK, WEXT, fdtd_multistep_kstep, tile_plan,
)

DT, DX = 5e-14, 1e-4


def _run(rows, cols, nsteps, K, src):
    eps = np.full((rows, cols), constants.EPSILON_0)
    eps[20:40, 50:70] *= 3.0
    mu = np.full((rows, cols), constants.MU_0)
    fc = 30e9

    ce, ch, coef = precompute_coefficients(eps, mu, DT, DX, jnp.float32)
    Ez = jnp.zeros((rows, cols), jnp.float32)
    Hx = jnp.zeros((rows, cols - 1), jnp.float32)
    Hy = jnp.zeros((rows - 1, cols), jnp.float32)
    Ez, Hx, Hy = fdtd_multistep_kstep(
        Ez, Hx, Hy, ce, ch, coef, DT, fc, src[0], src[1],
        nsteps, "ricker", 0, K=K, impl="reference")

    ref = numpy_simulate(eps, mu, DT, DX, nsteps, src, fc)
    err = np.max(np.abs(np.asarray(Ez, np.float64) - ref)) / np.max(np.abs(ref))
    return err, Ez, Hx, Hy


def test_ttiled_matches_oracle_multisweep():
    rows, cols = 64, 128   # 3 sweeps of K=8
    err, Ez, Hx, Hy = _run(rows, cols, nsteps=24, K=8,
                           src=(rows // 2, cols // 2))
    assert err < 1e-5, f"relative field error {err:.3e}"
    assert Hx.shape == (rows, cols - 1) and Hy.shape == (rows - 1, cols)


def test_ttiled_remainder_sweep():
    err, *_ = _run(64, 128, nsteps=21, K=8, src=(32, 64))
    assert err < 1e-5, f"relative field error {err:.3e}"


def test_ttiled_source_in_halo_overlap():
    # a source row the kernel would hold in one tile and its neighbours'
    # halos; the sweep arithmetic must inject it once
    err, *_ = _run(64, 128, nsteps=16, K=8, src=(17, 64))
    assert err < 1e-5, f"relative field error {err:.3e}"


def test_resolve_backend_picks_ttiled_beyond_vmem():
    """``auto`` takes the CUDA kernel on a GPU for float32 grids, and the
    XLA step on any other platform or dtype."""
    from fdtd2d.fdtd.simulate import resolve_backend

    for n in (2048, 4096, 8192):
        assert resolve_backend("auto", (n, n), platform="gpu") == "kstep"
        assert resolve_backend("auto", (n, n), platform="cpu") == "jax"
    assert resolve_backend("auto", (4096, 4096), jnp.float64, "gpu") == "jax"
    assert resolve_backend("jax", (4096, 4096), platform="gpu") == "jax"
    with pytest.raises(ValueError):
        resolve_backend("pallas", (2048, 2048))


def test_simulate_ttiled_backend_matches_jax():
    """The K-step driver reproduces the jax path through the same sweep
    bookkeeping simulate() uses, and simulate() refuses the kernel where
    there is no GPU instead of running anything else in its place."""
    from fdtd2d.fdtd.simulate import simulate, FDTDConfig

    rows, cols = 64, 128
    eps = np.full((rows, cols), constants.EPSILON_0)
    mu = np.full((rows, cols), constants.MU_0)
    cfg = dict(dt=DT, dx=DX, nsteps=20, source_xy=(rows // 2, cols // 2),
               source_fc=30e9)
    (want, _, _), _ = simulate(eps, mu, FDTDConfig(backend="jax", **cfg))
    ce, ch, coef = precompute_coefficients(eps, mu, DT, DX, jnp.float32)
    zeros = (jnp.zeros((rows, cols)), jnp.zeros((rows, cols - 1)),
             jnp.zeros((rows - 1, cols)))
    got, _, _ = fdtd_multistep_kstep(*zeros, ce, ch, coef, DT, 30e9, rows // 2,
                                     cols // 2, 20, "ricker", 0, K=6,
                                     impl="reference")
    err = np.max(np.abs(np.asarray(got) - np.asarray(want)))
    scale = np.max(np.abs(np.asarray(want)))
    assert err / scale < 1e-5, f"kstep-vs-jax driver mismatch: {err/scale:.2e}"
    with pytest.raises(RuntimeError, match="only on an NVIDIA GPU"):
        simulate(eps, mu, FDTDConfig(backend="kstep", **cfg))


def test_ttiled_source_near_boundary():
    # Mur band + corner evolution entangled with the source
    err, *_ = _run(64, 128, nsteps=16, K=8, src=(7, 9))
    assert err < 1e-5, f"relative field error {err:.3e}"


def test_ttiled_padded_rows_match_oracle():
    """N no tile multiple (72 rows in one 80-row tile at K=8): the last
    block writes only the rows that exist, and shapes round-trip."""
    TY, _, gy, _, _ = tile_plan(72, 128, 8)
    assert gy * TY >= 72 > (gy - 1) * TY
    err, Ez, Hx, Hy = _run(72, 128, nsteps=24, K=8, src=(36, 64))
    assert err < 1e-5, f"relative field error {err:.3e}"
    assert Ez.shape == (72, 128)
    assert Hx.shape == (72, 127) and Hy.shape == (71, 128)


def test_ttiled_padded_source_near_bottom():
    # the bottom band + corners evolve around the source
    err, *_ = _run(72, 128, nsteps=16, K=8, src=(69, 9))
    assert err < 1e-5, f"relative field error {err:.3e}"


def test_pick_panel_height_guards():
    """The tile plan refuses what the kernel would refuse: a halo that
    leaves no tile or is empty, a grid narrower than the Mur bands;
    ``auto`` then takes the XLA step."""
    from fdtd2d.fdtd.simulate import resolve_backend

    with pytest.raises(ValueError):
        tile_plan(4096, 4096, halo=48)          # 96-row block, no tile left
    with pytest.raises(ValueError):
        tile_plan(4096, 4096, halo=0)           # no steps per sweep
    with pytest.raises(ValueError):
        tile_plan(4096, 8, halo=4)              # below 2 Mur bands
    assert resolve_backend("auto", (4096, 8), platform="gpu") == "jax"
    assert resolve_backend("auto", (2056, 4104), platform="gpu") == "kstep"


def test_pick_sweep_depth_joint_choice():
    """The default plan: K = 12 steps per sweep in 96 x 128 loaded blocks,
    so each block writes 72 x 104 cells; four fields fill 192 KiB of the
    227 KiB a Hopper block may use; the grid covers every cell."""
    for n in (2048, 4096, 8192):
        TY, TX, gy, gx, smem = tile_plan(n, n, DEFAULT_K)
        assert (TY, TX) == (96 - 2 * DEFAULT_K, WEXT - 2 * DEFAULT_K) == (72, 104)
        assert smem == 4 * 96 * 128 * 4 <= SMEM_PER_BLOCK
        assert gy * TY >= n > (gy - 1) * TY and gx * TX >= n > (gx - 1) * TX
