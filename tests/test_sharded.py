"""Multi-device parity on the 8-device virtual CPU mesh.

The golden-oracle chain's distributed leg: sharded runs must reproduce the
single-device results exactly (same program, partitioned by GSPMD) or to
roundoff (explicit shard_map halos).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding

from fdtd2d import constants
from fdtd2d.parallel import (
    make_mesh, shard_operator, solve_fdfd_sharded, simulate_sharded,
    sharded_matvec_shardmap,
)
from fdtd2d.ops.helmholtz import make_operator
from fdtd2d.fdfd.solver import solve_fdfd
from fdtd2d.fdtd.simulate import simulate, FDTDConfig


def test_mesh_shapes():
    m = make_mesh()
    assert m.devices.size == 8
    m2 = make_mesh((4, 2))
    assert m2.devices.shape == (4, 2)


def _scene(N):
    rng = np.random.default_rng(21)
    eps = constants.EPSILON_0 * (1.0 + rng.random((N, N)))
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N)); src[N // 2, N // 3] = 5.0
    return eps, mu, src


def test_shardmap_matvec_matches_single_device():
    N = 64
    eps, mu, _ = _scene(N)
    op = make_operator(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=10,
                       dtype=jnp.complex128)
    mesh = make_mesh((8,), axis_names=("x",))
    mv = sharded_matvec_shardmap(op, mesh)

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    xs = jax.device_put(x, NamedSharding(mesh, P("x", None)))
    want = np.asarray(op.apply(x))
    got = np.asarray(mv(xs))
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < 1e-13, f"shard_map matvec mismatch: {err:.2e}"


def test_shardmap_matvec_2d_mesh_matches_single_device():
    """2D explicit halo exchange: both difference terms ppermute along their
    own mesh axis (the hand-SPMD fallback now matches the GSPMD 2D layout)."""
    N = 64
    eps, mu, _ = _scene(N)
    op = make_operator(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=10,
                       dtype=jnp.complex128)
    mesh = make_mesh((4, 2))
    mv = sharded_matvec_shardmap(op, mesh)

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    xs = jax.device_put(x, NamedSharding(mesh, P("x", "y")))
    want = np.asarray(op.apply(x))
    got = np.asarray(mv(xs))
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < 1e-13, f"2D shard_map matvec mismatch: {err:.2e}"


def test_sharded_fdfd_solve_matches_single_device():
    N = 96
    eps, mu, src = _scene(N)
    omega = 17e9
    op = make_operator(eps, mu, 1e-3, 1e-3, omega, pml_thickness=16,
                       dtype=jnp.complex128)
    b = jnp.asarray(-1j * omega * src, jnp.complex128)

    want = solve_fdfd(op, b, tol=1e-10, maxiter=120)
    mesh = make_mesh((2, 4))
    got = solve_fdfd_sharded(op, b, mesh, tol=1e-10, maxiter=120)

    assert float(got.relative_residual) < 1e-9
    err = np.max(np.abs(np.asarray(got.x) - np.asarray(want.x)))
    scale = np.max(np.abs(np.asarray(want.x)))
    assert err / scale < 1e-8, f"sharded solve mismatch: {err / scale:.2e}"


@pytest.mark.slow
def test_sharded_tiled_solve_matches_single_device():
    """The Schwarz machinery over the mesh: patches sharded over 8 devices
    (all_gather residual + psum_scatter write-back) must reproduce the
    single-device two-level krylov solve."""
    import jax.numpy as jnp

    from fdtd2d.fdfd.tiled import run_fdfd_tiled
    from fdtd2d.parallel.tiled_sharded import run_fdfd_tiled_sharded

    N, dx, omega = 160, 1e-3, 17e9
    eps = np.full((N, N), constants.EPSILON_0)
    eps[60:100, 40:70] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    source = np.zeros((N, N)); source[N // 2, N // 2] = 10.0

    kwargs = dict(patch_size=64, padding=24, pml_thickness=10,
                  solver_tol=1e-6, solver_maxiter=60, inner_iters=15,
                  global_pml_thickness=40, dtype=jnp.complex64,
                  refine_target=1e-7)
    want, wtrace = run_fdfd_tiled(eps, mu, dx, dx, omega, source,
                                  mode="krylov", **kwargs)
    mesh = make_mesh((8,), axis_names=("p",))
    got, gtrace = run_fdfd_tiled_sharded(eps, mu, dx, dx, omega, source,
                                         mesh, **kwargs)
    # trace[-2] = f64 iterate residual; trace[-1] = downcast-array residual
    assert gtrace[-2] < 1e-7, f"sharded tiled true residual: {gtrace[-2]:.2e}"
    assert gtrace[-1] < 5e-5
    err = np.max(np.abs(np.asarray(got) - np.asarray(want)))
    scale = np.max(np.abs(np.asarray(want)))
    assert err / scale < 1e-5, f"sharded tiled mismatch: {err / scale:.2e}"


def test_sharded_fdtd_matches_single_device():
    N = 96
    eps, mu, _ = _scene(N)
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=60, source_xy=(N // 2, N // 2),
                     source_fc=30e9, backend="jax", dtype=jnp.float64)
    (want, _, _), _ = simulate(eps, mu, cfg)

    mesh = make_mesh((2, 4))
    (got, hx, hy), _ = simulate_sharded(eps, mu, cfg, mesh)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-12)
    # contract: EVERY dispatch path returns the staggered single-device
    # shapes, and a round-tripped state is accepted back (continuation
    # matches a single-device continuation)
    assert hx.shape == (N, N - 1) and hy.shape == (N - 1, N)
    state1 = simulate(eps, mu, cfg)[0]
    (want2, _, _), _ = simulate(eps, mu, cfg, state=state1)
    (got2, _, _), _ = simulate_sharded(eps, mu, cfg, mesh, state=(got, hx, hy))
    np.testing.assert_allclose(np.asarray(got2), np.asarray(want2),
                               rtol=0, atol=1e-12)


def test_sharded_ttiled_fdtd_matches_oracle():
    """The row-sharded K-step path (shard_map + ppermute ghost rows around
    the sweep, here its plain-JAX reference) against the float64 NumPy
    oracle, not just the jax path.

    128 rows over 8 devices -> ln=16 rows each with K=12 ghost rows, so
    every sweep's halo crosses device boundaries."""
    from fdtd2d.fdtd.reference import numpy_simulate
    from fdtd2d.parallel.fdtd_sharded import (
        plan_sharded_kstep, simulate_sharded_kstep)

    N, M = 128, 128
    eps = np.full((N, M), constants.EPSILON_0)
    eps[20:40, 50:70] *= 3.0
    mu = np.full((N, M), constants.MU_0)
    src, fc, steps = (N // 2, M // 2), 30e9, 30

    assert plan_sharded_kstep(N, M, 8) == 12
    assert plan_sharded_kstep(64, M, 8) is None      # 8 own rows < K
    mesh = make_mesh((8,), axis_names=("x",))
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=steps, source_xy=src,
                     source_fc=fc)
    (Ez, Hx, Hy), _ = simulate_sharded_kstep(eps, mu, cfg, mesh,
                                             impl="reference")
    ref = numpy_simulate(eps, mu, 5e-14, 1e-4, steps, src, fc)
    err = np.max(np.abs(np.asarray(Ez, np.float64) - ref)) / np.max(np.abs(ref))
    assert err < 1e-5, f"sharded kstep field error vs oracle: {err:.3e}"
    assert Hx.shape == (N, M - 1) and Hy.shape == (N - 1, M)


def test_sharded_ttiled_source_on_device_boundary():
    """Source row in one device's own rows and another's ghost rows: the
    device-local source row must inject exactly once globally."""
    from fdtd2d.fdtd.reference import numpy_simulate
    from fdtd2d.parallel.fdtd_sharded import simulate_sharded_kstep

    N, M = 128, 128
    eps = np.full((N, M), constants.EPSILON_0)
    mu = np.full((N, M), constants.MU_0)
    src, fc, steps = (31, 9), 30e9, 19   # device boundary at row 32; rem sweep

    mesh = make_mesh((8,), axis_names=("x",))
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=steps, source_xy=src,
                     source_fc=fc)
    (Ez, _, _), _ = simulate_sharded_kstep(eps, mu, cfg, mesh,
                                           impl="reference")
    ref = numpy_simulate(eps, mu, 5e-14, 1e-4, steps, src, fc)
    err = np.max(np.abs(np.asarray(Ez, np.float64) - ref)) / np.max(np.abs(ref))
    assert err < 1e-5, f"boundary-source sharded kstep error: {err:.3e}"


def test_simulate_sharded_dispatches_to_ttiled():
    """simulate_sharded takes the kernel path only where the kernel runs:
    on the CPU ``auto`` is the GSPMD jax path and ``kstep`` is refused.
    The kernel path's decomposition (reference sweep) matches the jax path
    with snapshots riding along."""
    from fdtd2d.parallel.fdtd_sharded import simulate_sharded_kstep

    N, M = 128, 128
    eps, mu, _ = _scene(N)
    eps = np.broadcast_to(eps[:, :1], (N, M)).copy()
    mu = np.full((N, M), constants.MU_0)
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=48, source_xy=(32, 64),
                     source_fc=30e9, nframes=2, backend="auto")
    mesh = make_mesh((8,), axis_names=("x",))
    (got, _, _), snaps = simulate_sharded(eps, mu, cfg, mesh)
    (kgot, _, _), ksnaps = simulate_sharded_kstep(eps, mu, cfg, mesh,
                                                  impl="reference")
    assert snaps is not None and snaps.shape == (2, N, M)
    assert ksnaps is not None and ksnaps.shape == (2, N, M)

    cfgj = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=48, source_xy=(32, 64),
                      source_fc=30e9, backend="jax")
    (want, _, _), _ = simulate(eps, mu, cfgj)
    scale = np.max(np.abs(np.asarray(want)))
    for g in (got, kgot):
        err = np.max(np.abs(np.asarray(g) - np.asarray(want)))
        assert err / scale < 1e-5, f"sharded vs jax mismatch: {err/scale:.2e}"
    with pytest.raises(RuntimeError, match="only on an NVIDIA GPU"):
        simulate_sharded(eps, mu, dataclasses.replace(cfg, backend="kstep"),
                         mesh)
