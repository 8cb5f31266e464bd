"""Mesh-sharded time-domain solver: parity with the single-device path.

The sharded solver runs the SAME jitted step programs, only partitioned
(sub-axis batch + GSPMD column halos), so agreement is to f32 collective
reassociation — not a physics tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fdtd2d import constants
from fdtd2d.fdfd.timedomain import TimeDomainSolver
from fdtd2d.parallel.mesh import make_mesh
from fdtd2d.parallel.timedomain_sharded import (
    TimeDomainSolverSharded, shard_wave_bundle,
)


def _scene(N=64):
    eps = np.full((N, N), constants.EPSILON_0)
    eps[20:40, 24:44] *= 2.0
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N), np.complex64)
    src[N // 2 + 3, N // 2 - 5] = 1.0
    return eps, mu, src


def _solvers(N=64, **sharded_kw):
    eps, mu, src = _scene(N)
    kw = dict(pml_thickness=8, transits=1.5)
    base = TimeDomainSolver(eps, mu, 1e-3, 1e-3, 30e9, **kw)
    mesh = make_mesh((4, 2), axis_names=("sub", "c"))
    shd = TimeDomainSolverSharded(eps, mu, 1e-3, 1e-3, 30e9, mesh,
                                  **kw, **sharded_kw)
    return base, shd, jnp.asarray(src)


def test_precondition_parity_sub_and_col_axes():
    base, shd, src = _solvers(sub_axis="sub", col_axis="c")
    a = np.asarray(base.precondition(src))
    b = np.asarray(shd.precondition(src))
    denom = np.linalg.norm(a)
    assert denom > 0
    assert np.linalg.norm(a - b) / denom < 1e-5


def test_precondition_parity_chunked_dispatches():
    # force the chunked settle path (sharded zeros + bounded dispatches)
    base, shd, src = _solvers(sub_axis="sub", col_axis="c")
    shd.max_dispatch_steps = 64
    assert shd.bundle.n_main > 64  # the chunked branch actually runs
    a = np.asarray(base.precondition(src))
    b = np.asarray(shd.precondition(src))
    assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-5


def test_sharded_solve_true_residual():
    # the convergent-solve configuration from tests/test_timedomain.py:
    # contrast 1.5, wide PML, 12 settle transits (each refinement round
    # contracts by the per-application transient level; the 2x-contrast
    # parity scene at 1.5 transits floors near 1e-3)
    N = 64
    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3: 2 * N // 3, N // 4: N // 2] *= 1.5
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N), np.complex64)
    src[N // 2 + 3, N // 2 - 5] = 1.0
    mesh = make_mesh((4, 2), axis_names=("sub", "c"))
    shd = TimeDomainSolverSharded(eps, mu, 1e-3, 1e-3, 30e9, mesh,
                                  sub_axis="sub", col_axis="c",
                                  pml_thickness=16, transits=12.0)
    x, trace = shd.solve(jnp.asarray(src), refine_target=1e-6,
                         max_refine_rounds=12)
    assert trace[-2] < 1e-6          # f64 iterate's TRUE residual
    assert np.isfinite(np.abs(np.asarray(x)).max())


def test_col_axis_only_mesh():
    # column-sharding alone (sub axis replicated): the 8192^2+ layout when
    # the mesh has more than 4 devices along one axis
    eps, mu, src = _scene()
    mesh = make_mesh((8,), axis_names=("c",))
    base = TimeDomainSolver(eps, mu, 1e-3, 1e-3, 30e9,
                            pml_thickness=8, transits=1.0)
    shd = TimeDomainSolverSharded(eps, mu, 1e-3, 1e-3, 30e9, mesh,
                                  col_axis="c", pml_thickness=8,
                                  transits=1.0)
    a = np.asarray(base.precondition(jnp.asarray(src)))
    b = np.asarray(shd.precondition(jnp.asarray(src)))
    assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-5


def test_axis_validation():
    eps, mu, _ = _scene()
    mesh = make_mesh((8,), axis_names=("c",))
    with pytest.raises(ValueError, match="at least one"):
        TimeDomainSolverSharded(eps, mu, 1e-3, 1e-3, 30e9, mesh)
    with pytest.raises(ValueError, match="1, 2, or 4"):
        TimeDomainSolverSharded(eps, mu, 1e-3, 1e-3, 30e9, mesh,
                                sub_axis="c")


def test_dense_mu_bundle_shards():
    # non-constant mu takes the dense stencil layout; shard placement only
    eps, mu, src = _scene()
    mu = mu * (1.0 + 0.1 * np.linspace(0, 1, mu.shape[0])[:, None])
    mesh = make_mesh((4, 2), axis_names=("sub", "c"))
    base = TimeDomainSolver(eps, mu, 1e-3, 1e-3, 30e9,
                            pml_thickness=8, transits=1.0)
    assert base.bundle.dense
    shd = TimeDomainSolverSharded(eps, mu, 1e-3, 1e-3, 30e9, mesh,
                                  sub_axis="sub", col_axis="c",
                                  pml_thickness=8, transits=1.0)
    a = np.asarray(base.precondition(jnp.asarray(src)))
    b = np.asarray(shd.precondition(jnp.asarray(src)))
    assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-5
