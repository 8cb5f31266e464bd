"""Mesh-sharded frequency-locked time-domain solve (fdfd/timedomain.py).

The wave state is a (4, nr, nc) complex stack — four independent
sublattice systems stepped in lockstep — so it shards over TWO mesh axes
at once:

- ``sub``: the leading sublattice axis. The four systems never couple
  (fdfd/direct.py:8-28 — they meet only at the RHS split / solution
  merge), so this axis is embarrassingly parallel: ZERO per-step
  communication, up to 4 devices.
- ``col``: the trailing grid-column axis. The per-step coupling is the
  ±1-column pad-shift of the real stencil ``M_col`` plus the thin PML
  filter strips; under GSPMD the jitted scan partitions with one halo
  collective-permute per step — the same pattern the sharded FDTD layer
  uses (parallel/fdtd_sharded.py), just compiler-inserted instead of
  hand-written (the time-domain step is a pure-JAX stencil, so XLA owns
  the schedule anyway).

Together a (4, C) mesh divides the resident state — u, uprev, the drive,
and the filter strips, ~56 B/cell over the full grid — by 4·C. That is
the path to exact wavelength-robust solves at 8192²+ (a 13 GB state on
one chip, 1.7 GB/device on a (4, 2) slice), the regime where every
stored-factor mode is past its memory wall (fdfd/direct.py) and the
iterative stack stalls with electrical size (fdfd/tiled.py:38-47).

The reference has no distributed solves at all (SURVEY.md §2.3 — its
scaling story ends at the sequential tiled sweep,
/root/reference/python-src/tiled_solver.py:111-224); this is the sixth
distributed leg next to the sharded FDTD kernel, GSPMD FDFD, shard_map
matvecs, the sublattice-sharded direct solve, and the patch-sharded
Schwarz preconditioner.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fdtd2d.fdfd.timedomain import (
    TimeDomainSolver, WaveBundle, _avg_run, _fetch_real, _merge_sub,
    _settle_segment, _split_sub, wave_run,
)
from fdtd2d.ops.cplx import czeros


def bundle_shardings(bundle: WaveBundle, mesh: Mesh,
                     sub_axis: Optional[str], col_axis: Optional[str]):
    """Per-field NamedShardings for a :class:`WaveBundle` on ``mesh``.

    ``sub_axis`` shards the leading length-4 sublattice axis (mesh dim of
    1, 2, or 4); ``col_axis`` shards the grid-column axis. Either may be
    ``None`` (replicated along that direction). Filter strips and the
    scalar drive phase are small and column-local only in part, so they
    shard on ``sub`` alone."""
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    grid3 = s(sub_axis, None, col_axis)
    subrow = s(sub_axis, None)          # (4, nr) row vectors
    subcol = s(sub_axis, col_axis)      # (4, nc) column vectors
    strip = s(sub_axis, None, None)     # (4, 1, 2t) / (4, 2t, 1) filters
    if bundle.dense:
        stencil = dict(dc=grid3, dr=grid3, e_c=grid3, w_c=grid3,
                       s_r=grid3, n_r=grid3)
    else:
        stencil = dict(dc=subcol, e_c=subcol, w_c=subcol,
                       dr=subrow, s_r=subrow, n_r=subrow)
    return dict(
        inv_eps_dt2=grid3, d0_col=strip, gg_col=strip, d0_row=strip,
        gg_row=strip, hd_r=subrow, hd_c=subcol, theta=s(), **stencil)


def shard_wave_bundle(bundle: WaveBundle, mesh: Mesh, *,
                      sub_axis: Optional[str] = None,
                      col_axis: Optional[str] = None) -> WaveBundle:
    """Place every bundle array on ``mesh`` (see :func:`bundle_shardings`)."""
    sh = bundle_shardings(bundle, mesh, sub_axis, col_axis)
    return dataclasses.replace(bundle, **{
        k: jax.device_put(getattr(bundle, k), v) for k, v in sh.items()})


def _wave_run_chunked_sharded(bundle: WaveBundle, b_sub: jax.Array,
                              seg_steps: int, state_sh, strip_col_sh,
                              strip_row_sh) -> jax.Array:
    """:func:`fdtd2d.fdfd.timedomain.wave_run_chunked` with the carry
    state (u/uprev/psi) created under explicit shardings, so the scan
    programs partition from the first dispatch instead of GSPMD picking a
    layout from replicated zeros."""
    n_main = bundle.n_main
    if seg_steps >= n_main:
        return wave_run(bundle, b_sub)
    z = lambda shape, sh: jax.device_put(czeros(shape, b_sub.dtype), sh)
    u = z(b_sub.shape, state_sh)
    uprev = z(b_sub.shape, state_sh)
    B, nr, nc = b_sub.shape
    zc = lambda: z((B, nr, 2 * bundle.t), strip_col_sh)
    zr = lambda: z((B, 2 * bundle.t, nc), strip_row_sh)
    psi = (zc(), zr(), zc(), zr(), zc(), zr())
    k0 = 0
    while k0 < n_main:
        n = min(seg_steps, n_main - k0)
        u, uprev, psi = _settle_segment(bundle, b_sub, u, uprev, psi,
                                        jnp.int32(k0), nsteps=n)
        float(_fetch_real(u))           # bounded-dispatch sync
        k0 += n
    return _avg_run(bundle, b_sub, u, uprev, psi)


class TimeDomainSolverSharded(TimeDomainSolver):
    """:class:`TimeDomainSolver` with the wave state sharded over a mesh.

    Same ``solve``/``precondition`` contract (TRUE-f64-residual traces via
    mixed-precision refinement); only the placement differs. Validated by
    parity against the single-device solver on a (4, 2) CPU mesh
    (tests/test_timedomain_sharded.py) and exercised by the multi-chip
    dryrun; its multi-card throughput is not measured yet."""

    def __init__(self, eps, mu, dx, dy, omega, mesh: Mesh, *,
                 sub_axis: Optional[str] = None,
                 col_axis: Optional[str] = None, **kwargs):
        if sub_axis is None and col_axis is None:
            raise ValueError("name at least one of sub_axis/col_axis")
        for name, size_ok in ((sub_axis, lambda n: n in (1, 2, 4)),
                              (col_axis, lambda n: True)):
            if name is not None:
                if name not in mesh.axis_names:
                    raise ValueError(f"axis {name!r} not in {mesh.axis_names}")
                if not size_ok(mesh.shape[name]):
                    raise ValueError("sub_axis must have 1, 2, or 4 devices "
                                     "(the sublattice axis has length 4)")
        super().__init__(eps, mu, dx, dy, omega, **kwargs)
        self.mesh = mesh
        self.bundle = shard_wave_bundle(self.bundle, mesh,
                                        sub_axis=sub_axis, col_axis=col_axis)
        s = lambda *spec: NamedSharding(mesh, P(*spec))
        self._state_sh = s(sub_axis, None, col_axis)
        self._strip_col_sh = s(sub_axis, None, None)
        self._strip_row_sh = s(sub_axis, None, col_axis)

    def precondition(self, b: jax.Array) -> jax.Array:
        b_sub = jax.device_put(_split_sub(b), self._state_sh)
        x_sub = _wave_run_chunked_sharded(
            self.bundle, b_sub, self.max_dispatch_steps, self._state_sh,
            self._strip_col_sh, self._strip_row_sh)
        return _merge_sub(x_sub, b)
