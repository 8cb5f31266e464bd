"""Sharded solvers: grid axes over a device mesh, collectives between devices.

Two complementary mechanisms:

1. GSPMD (production path): place the field/operator arrays with
   ``NamedSharding`` and jit the existing single-program code —  XLA's SPMD
   partitioner inserts the halo ``collective-permute``s for the stencil
   shifts and ``all-reduce``s for the Krylov dot products. Zero algorithm
   changes; this is how the FDTD scan, the FDFD solve (incl. the FDM
   preconditioner's dense matmuls), and training all scale.

2. Explicit ``shard_map`` + ``jax.lax.ppermute`` halo exchange for the
   Helmholtz matvec — the hand-written SPMD form of the same stencil,
   kept as the building block where manual comm/compute control is needed
   and as a readable statement of what GSPMD generates. ppermute's
   "non-receiving devices get zeros" semantics exactly implements the
   operator's zero-truncated boundary.

The reference has no distributed backend at all (SURVEY.md section 2.3);
its closest analog is NumPy slice copies between sequential patch solves
(reference: python-src/tiled_solver.py:200-218).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from fdtd2d.ops.helmholtz import HelmholtzOperator
from fdtd2d.fdfd.solver import solve_fdfd, SolveResult


def shard_operator(op: HelmholtzOperator, mesh: Mesh) -> HelmholtzOperator:
    """Place operator fields on the mesh: (Nx, Ny) arrays over ('x','y'),
    the 1D stretch factors along their matching axis, scalars replicated."""
    ax = mesh.axis_names
    s2d = NamedSharding(mesh, P(*ax[:2]))
    srow = NamedSharding(mesh, P(ax[0]))
    scol = NamedSharding(mesh, P(ax[1] if len(ax) > 1 else None))
    srep = NamedSharding(mesh, P())
    return dataclasses.replace(
        op,
        eps=jax.device_put(op.eps, s2d),
        inv_mu=jax.device_put(op.inv_mu, s2d),
        inv_s_row=jax.device_put(op.inv_s_row, srow),
        inv_s_col=jax.device_put(op.inv_s_col, scol),
        omega=jax.device_put(op.omega, srep),
        inv_2dx=jax.device_put(op.inv_2dx, srep),
        inv_2dy=jax.device_put(op.inv_2dy, srep),
    )


def solve_fdfd_sharded(op: HelmholtzOperator, b, mesh: Mesh, **solve_kwargs) -> SolveResult:
    """FDFD solve with the grid sharded over the mesh (GSPMD partitioning).

    Build the FDM preconditioner first (host side) and pass it via
    ``preconditioner=`` if you need it prebuilt; the default "fdm" resolves
    here (outside jit) and its dense factors get replicated/sharded by XLA.
    """
    sharded = shard_operator(op, mesh)
    b = jax.device_put(jnp.asarray(b).reshape(op.shape),
                       NamedSharding(mesh, P(*mesh.axis_names[:2])))
    return solve_fdfd(sharded, b, **solve_kwargs)


def _to_staggered(state, N, M):
    """Normalize an (Ez, Hx, Hy) state to the staggered single-device
    shapes (Hx (N, M-1), Hy (N-1, M)). Padded arrays' extra column/row feed
    only zero-coefficient updates, so truncation is lossless."""
    Ez, Hx, Hy = state
    if Hx.shape[1] == M:
        Hx = Hx[:, : M - 1]
    if Hy.shape[0] == N:
        Hy = Hy[: N - 1, :]
    return Ez, Hx, Hy


def simulate_sharded(eps, mu, config, mesh: Mesh, state=None):
    """FDTD rollout sharded over the mesh.

    Contract matches single-device :func:`~fdtd2d.fdtd.simulate` on
    EVERY dispatch path: returns ``(Ez, Hx, Hy), snapshots`` with the
    staggered shapes (Hx (N, M-1), Hy (N-1, M)); ``state`` is accepted in
    either the staggered or the padded (N, M) convention (a round-tripped
    result from any prior call works).

    Backend resolution (config.backend):
    - "kstep", or "auto" on a GPU, with a 1-D mesh whose row decomposition
      the K-step sweep admits: shard_map + ppermute ghost rows around the
      CUDA kernel (fdtd2d/parallel/fdtd_sharded.py).
    - anything else ("jax", 2-D meshes, other platforms): GSPMD — place
      the arrays with NamedSharding and jit the pure-JAX step; XLA inserts
      the halo collectives.
    """
    from fdtd2d.fdtd.simulate import resolve_backend, simulate

    N, M = jnp.asarray(eps).shape
    if state is not None:
        state = _to_staggered(state, N, M)

    if resolve_backend(config.backend, (N, M), config.dtype) == "kstep":
        from fdtd2d.parallel.fdtd_sharded import (
            plan_sharded_kstep, simulate_sharded_kstep)

        D = mesh.devices.shape[0]
        if mesh.devices.ndim == 1 and plan_sharded_kstep(N, M, D) is not None:
            return simulate_sharded_kstep(eps, mu, config, mesh, state=state)
        if config.backend == "kstep":
            raise ValueError(f"grid {(N, M)} over mesh {mesh.devices.shape} "
                             "admits no kstep row decomposition")

    # GSPMD path. padded=True: uniform (N, N) field shapes shard
    # evenly — XLA's SPMD partitioner produces wrong halo values for the
    # unevenly-sharded staggered (N, N-1) shapes (observed on CPU backend)
    cfg = dataclasses.replace(config, backend="jax", padded=True)
    sh = NamedSharding(mesh, P(*mesh.axis_names[:2]))
    eps = jax.device_put(jnp.asarray(eps, cfg.dtype), sh)
    mu = jax.device_put(jnp.asarray(mu, cfg.dtype), sh)
    if state is not None:
        Ez, Hx, Hy = (jnp.asarray(s, cfg.dtype) for s in state)
        state = tuple(jax.device_put(s, sh) for s in (
            Ez, jnp.pad(Hx, ((0, 0), (0, 1))), jnp.pad(Hy, ((0, 1), (0, 0)))))
    fields, snaps = simulate(eps, mu, cfg, state=state)
    return _to_staggered(fields, N, M), snaps


# ---------------------------------------------------------------------------
# Explicit shard_map halo-exchange matvec
# ---------------------------------------------------------------------------


def _shift_from_above(f, axis_name):
    """Each shard receives its upper neighbor's LAST row (zeros at the top)."""
    n = jax.lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]
    return jax.lax.ppermute(f[-1:, :], axis_name, perm)


def _shift_from_below(f, axis_name):
    n = jax.lax.axis_size(axis_name)
    perm = [(i + 1, i) for i in range(n - 1)]
    return jax.lax.ppermute(f[:1, :], axis_name, perm)


def _drow_halo(f, inv2d, axis_name):
    """Central difference along rows with 1-row ppermute halo exchange.

    (f[r+1] - f[r-1]) * inv2d with zero truncation at the global boundary —
    ppermute leaves non-receiving edge shards with zeros, which IS the
    boundary condition.
    """
    above = _shift_from_above(f, axis_name)   # row r-1 for local row 0
    below = _shift_from_below(f, axis_name)   # row r+1 for local row -1
    fp = jnp.concatenate([f[1:, :], below], axis=0)
    fm = jnp.concatenate([above, f[:-1, :]], axis=0)
    return (fp - fm) * inv2d


def _shift_from_left(f, axis_name):
    """Each shard receives its left neighbor's LAST column (zeros at the
    global left edge)."""
    n = jax.lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]
    return jax.lax.ppermute(f[:, -1:], axis_name, perm)


def _shift_from_right(f, axis_name):
    n = jax.lax.axis_size(axis_name)
    perm = [(i + 1, i) for i in range(n - 1)]
    return jax.lax.ppermute(f[:, :1], axis_name, perm)


def _dcol_halo(f, inv2d, axis_name):
    """Central difference along columns with 1-column ppermute halo exchange
    (the column-axis twin of :func:`_drow_halo`)."""
    left = _shift_from_left(f, axis_name)     # col c-1 for local col 0
    right = _shift_from_right(f, axis_name)   # col c+1 for local col -1
    fp = jnp.concatenate([f[:, 1:], right], axis=1)
    fm = jnp.concatenate([left, f[:, :-1]], axis=1)
    return (fp - fm) * inv2d


def sharded_matvec_shardmap(op: HelmholtzOperator, mesh: Mesh):
    """Hand-written SPMD Helmholtz matvec with the grid sharded over BOTH
    mesh axes and halos via ppermute. Returns a jitted ``x -> A x`` on a
    sharded (Nx, Ny) field.

    With a 1-axis mesh, columns stay replicated and only the row-axis term
    communicates; on a 2D mesh both difference terms exchange one-cell halos
    along their own mesh axis — the fallback path to hand-tune when GSPMD
    mispartitions (as it did for staggered FDTD shapes, fdtd/step.py:44-52),
    now at feature parity with the GSPMD 2D layout."""
    ax_r = mesh.axis_names[0]
    ax_c = mesh.axis_names[1] if len(mesh.axis_names) > 1 else None
    spec2d = P(ax_r, ax_c)

    def local_apply(eps, inv_mu, inv_s_row, inv_s_col, x):
        def dcol(f, inv2d):
            if ax_c is not None:
                return _dcol_halo(f, inv2d, ax_c)
            fp = jnp.pad(f[:, 1:], ((0, 0), (0, 1)))
            fm = jnp.pad(f[:, :-1], ((0, 0), (1, 0)))
            return (fp - fm) * inv2d

        isc = inv_s_col[None, :]
        isr = inv_s_row[:, None]
        tc = dcol(x * isc, op.inv_2dx)
        tc = dcol(tc * inv_mu, op.inv_2dx) * isc
        tr = _drow_halo(x * isr, op.inv_2dy, ax_r)
        tr = _drow_halo(tr * inv_mu, op.inv_2dy, ax_r) * isr
        return -(tc + tr) - (op.omega**2) * eps * x

    f = shard_map(
        local_apply, mesh=mesh,
        in_specs=(spec2d, spec2d, P(ax_r), P(ax_c), spec2d),
        out_specs=spec2d,
    )
    return jax.jit(lambda x: f(op.eps, op.inv_mu, op.inv_s_row, op.inv_s_col, x))
