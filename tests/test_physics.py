"""Physics invariants: absorption, reciprocity, point-source symmetry."""

import numpy as np
import jax.numpy as jnp

from fdtd2d import constants
from fdtd2d.fdtd.simulate import simulate, FDTDConfig
from fdtd2d.ops.helmholtz import make_operator
from fdtd2d.fdfd.solver import solve_fdfd


def test_mur_boundary_absorbs_energy():
    """After the Ricker pulse passes, field energy must decay (absorbed),
    not reflect and persist — the role of the Mur ABC bands."""
    N = 96
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    # pulse fc=30 GHz peaks at step 1/(fc*dt) ~ 667; run past it and compare
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=2400, source_xy=(N // 2, N // 2),
                     source_fc=30e9, nframes=24, backend="jax")
    _, snaps = simulate(eps, mu, cfg)
    energy = np.asarray(jnp.sum(snaps**2, axis=(1, 2)))
    peak = energy.argmax()
    assert energy[-1] < 0.2 * energy[peak], (
        f"energy not absorbed: peak {energy[peak]:.3e} final {energy[-1]:.3e}")


def test_fdfd_reciprocity():
    """Green's function symmetry: A is complex symmetric, so the field at r2
    from a source at r1 equals the field at r1 from a source at r2.

    Probes sit a few wavelengths apart in a piecewise-uniform medium (in a
    per-cell random medium the field localizes and decays ~15 orders across
    the grid, leaving nothing meaningful to compare)."""
    N, dx, omega = 96, 1e-3, 17e9
    eps = np.full((N, N), constants.EPSILON_0)
    eps[40:70, 20:45] *= 2.0
    mu = np.full((N, N), constants.MU_0)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=16,
                       dtype=jnp.complex128)
    p1, p2 = (40, 44), (58, 52)

    def solve_from(p):
        b = jnp.zeros((N, N), jnp.complex128).at[p].set(1.0)
        return solve_fdfd(op, b, tol=1e-12, maxiter=400).x

    x1 = solve_from(p1)
    x2 = solve_from(p2)
    g12 = complex(x1[p2])
    g21 = complex(x2[p1])
    assert abs(g12 - g21) / abs(g12) < 1e-6, f"reciprocity violated: {g12} vs {g21}"


def test_fdtd_symmetry_uniform_medium():
    """A centered point source in a uniform medium must produce a field
    symmetric under the grid's diagonal reflection (Ez(x,y) = Ez(y,x))."""
    N = 97  # odd so the center is exact
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=150, source_xy=(N // 2, N // 2),
                     source_fc=30e9, backend="jax", dtype=jnp.float64)
    (Ez, _, _), _ = simulate(eps, mu, cfg)
    Ez = np.asarray(Ez)
    scale = np.abs(Ez).max()
    # the staggered update is not exactly transpose-symmetric cell-for-cell;
    # compare at coarse tolerance away from the staggering bias
    assert np.abs(Ez - Ez.T).max() / scale < 0.1
