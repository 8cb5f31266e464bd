"""FDTD rollout driver: ``lax.scan`` over frames, source injection, snapshots.

Replaces the reference's Python time loop with per-frame PNG writes
(reference: python-src/fdtd.py:30-40) by a fully on-device scan: an outer
scan over frames emits strided Ez snapshots as scan outputs, and each frame
advances ``steps_per_frame`` leapfrog steps with the selected backend:

- ``"jax"``   — pure-JAX step under ``lax.fori_loop`` (XLA-fused; any grid
                size, dtype and platform).
- ``"kstep"`` — the K-step temporally blocked CUDA kernel
                (fdtd2d/ops/kstep.py): K leapfrog steps per pass over device
                memory. NVIDIA GPU (sm_90a) and float32 only.
- ``"auto"``  — ``kstep`` on a GPU for float32 grids it admits, else ``jax``.

The source is a scalar amplitude scatter-add (no per-step full-grid
allocation like reference python-src/main.py:185).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from fdtd2d.core.sources import ricker_amplitude, sinusoidal_amplitude
from fdtd2d.fdtd.step import fdtd_step, fdtd_step_padded, precompute_coefficients

BACKENDS = ("auto", "jax", "kstep")


@dataclasses.dataclass(frozen=True)
class FDTDConfig:
    dt: float
    dx: float
    nsteps: int
    source_xy: Tuple[int, int]
    source_fc: float
    source_kind: str = "ricker"        # "ricker" | "sinusoidal"
    nframes: int = 0                   # 0 = no snapshots
    backend: str = "auto"              # one of BACKENDS
    padded: bool = False               # uniform (N, M) field shapes (sharded runs)
    dtype: object = jnp.float32


def _source_amp(kind: str, t, fc):
    if kind == "ricker":
        return ricker_amplitude(t, fc)
    return sinusoidal_amplitude(t, fc)


def resolve_backend(backend: str, shape: Tuple[int, int], dtype=jnp.float32,
                    platform: Optional[str] = None) -> str:
    """The backend a run takes. ``auto`` takes the CUDA kernel wherever it
    can run (a GPU, float32, a grid the tile plan admits), since it
    measured faster than the XLA step at every size from 256² up (PERF.md);
    everywhere else it takes the XLA step. No backend has an interpret
    mode."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not one of {BACKENDS}")
    if backend != "auto":
        return backend
    from fdtd2d.ops.kstep import DEFAULT_K, tile_plan

    platform = platform or jax.default_backend()
    if platform != "gpu" or jnp.dtype(dtype) != jnp.float32:
        return "jax"
    try:
        tile_plan(*shape, DEFAULT_K)
    except ValueError:
        return "jax"
    return "kstep"


def _advance(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps: int,
             source_kind: str, step_offset, backend: str):
    """Advance ``nsteps`` steps from (traced) global step ``step_offset``."""
    if backend == "kstep":
        from fdtd2d.ops.kstep import advance_padded

        return advance_padded(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy,
                              nsteps, source_kind, step_offset)

    step_offset = jnp.asarray(step_offset, jnp.int32)

    step_fn = fdtd_step_padded if Hx.shape == Ez.shape else fdtd_step

    # Inject through a loop-invariant one-hot mask, NOT Ez.at[sx, sy].add:
    # under GSPMD a scalar scatter-add inside the loop is applied once PER
    # SHARD when the fields are 2D-sharded (measured on the CPU SPMD
    # partitioner: the injected field comes out ~D times too large), while
    # an elementwise add partitions trivially and exactly.
    rows = jax.lax.broadcasted_iota(jnp.int32, Ez.shape, 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, Ez.shape, 1)
    hot = ((rows == sx) & (cols == sy)).astype(Ez.dtype)

    def body(i, carry):
        Ez, Hx, Hy = carry
        Ez, Hx, Hy = step_fn(Ez, Hx, Hy, ce, ch, coef)
        t = (step_offset + i).astype(ce.dtype) * dt
        amp = _source_amp(source_kind, t, fc)
        Ez = Ez + amp.astype(Ez.dtype) * hot
        return Ez, Hx, Hy

    return jax.lax.fori_loop(0, nsteps, body, (Ez, Hx, Hy))


@partial(jax.jit, static_argnames=("nsteps", "source_kind", "sx", "sy", "backend",
                                   "nframes", "steps_per_frame"))
def _run(Ez, Hx, Hy, ce, ch, coef, dt, fc, *, sx, sy, nsteps: int,
         source_kind: str, backend: str, nframes: int, steps_per_frame: int):
    shapes = (Hx.shape, Hy.shape)
    if backend == "kstep":
        # the kernel's padded layout, converted once per run, not per frame
        from fdtd2d.ops.kstep import to_padded_layout

        Hx, Hy, ce, ch = to_padded_layout(Hx, Hy, ce, ch, Ez.shape)

    def advance(fields, n, offset):
        return _advance(*fields, ce, ch, coef, dt, fc, sx, sy, n, source_kind,
                        offset, backend)

    fields, snaps = (Ez, Hx, Hy), None
    if nframes > 0:
        def frame(carry, k):
            carry = advance(carry, steps_per_frame, k * steps_per_frame)
            return carry, carry[0]

        fields, snaps = jax.lax.scan(frame, fields, jnp.arange(nframes))
    remainder = nsteps - nframes * steps_per_frame
    if remainder > 0:
        fields = advance(fields, remainder, nframes * steps_per_frame)
    Ez, Hx, Hy = fields
    return (Ez, Hx[: shapes[0][0], : shapes[0][1]],
            Hy[: shapes[1][0], : shapes[1][1]]), snaps


def simulate(eps, mu, config: FDTDConfig, state=None):
    """Run an FDTD rollout.

    Returns ``(Ez, Hx, Hy), snapshots`` where ``snapshots`` is a
    ``(nframes, N, M)`` array of strided Ez frames (or None if nframes=0).

    Frame timing deviation from the reference: frame k is emitted after
    ``(k+1)*steps_per_frame`` steps (the natural scan-output points), while
    the reference captures at ``i % steps_per_frame == 0`` inside its loop,
    i.e. after ``k*steps_per_frame + 1`` steps (python-src/fdtd.py:36-38) —
    a constant offset of ``steps_per_frame - 1`` steps per frame.
    """
    dtype = config.dtype
    eps = jnp.asarray(eps, dtype)
    mu = jnp.asarray(mu, dtype)
    rows, cols = eps.shape
    if state is None:
        Ez = jnp.zeros((rows, cols), dtype)
        if config.padded:
            Hx = jnp.zeros((rows, cols), dtype)
            Hy = jnp.zeros((rows, cols), dtype)
        else:
            Hx = jnp.zeros((rows, cols - 1), dtype)
            Hy = jnp.zeros((rows - 1, cols), dtype)
    else:
        Ez, Hx, Hy = state

    ce, ch, coef = precompute_coefficients(eps, mu, config.dt, config.dx, dtype)
    if config.padded:
        ch = jnp.pad(ch, ((0, 1), (0, 1)))
    dt = jnp.asarray(config.dt, dtype)
    fc = jnp.asarray(config.source_fc, dtype)
    sx, sy = config.source_xy
    backend = resolve_backend(config.backend, (rows, cols), dtype)

    if config.nframes > 0:
        steps_per_frame = max(config.nsteps // config.nframes, 1)
        nframes = config.nsteps // steps_per_frame
    else:
        steps_per_frame, nframes = 0, 0

    return _run(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx=sx, sy=sy,
                nsteps=config.nsteps, source_kind=config.source_kind,
                backend=backend, nframes=nframes,
                steps_per_frame=steps_per_frame)


@partial(jax.jit, static_argnames=("nsteps", "nframes", "steps_per_frame",
                                   "source_kind"))
def _simulate_batched_core(eps_batch, mu_batch, sources_xy, dt, dx, fc, *,
                           nsteps: int, nframes: int, steps_per_frame: int,
                           source_kind: str):
    """Module-level jitted core for :func:`simulate_batched`: the compile
    cache is keyed on (shapes, dtype, static config) so repeated sweeps —
    datagen calling with fresh scene batches — reuse one compilation.
    dt/dx/fc are traced scalars: changing their values does not retrace."""
    dtype = eps_batch.dtype
    rows, cols = eps_batch.shape[1:]

    def one(eps, mu, sxy):
        ce, ch, coef = precompute_coefficients(eps, mu, dt, dx, dtype)
        Ez = jnp.zeros((rows, cols), dtype)
        Hx = jnp.zeros((rows, cols - 1), dtype)
        Hy = jnp.zeros((rows - 1, cols), dtype)

        def advance(Ez, Hx, Hy, n, offset):
            def body(i, c):
                Ez, Hx, Hy = c
                Ez, Hx, Hy = fdtd_step(Ez, Hx, Hy, ce, ch, coef)
                t = (offset + i).astype(dtype) * dt
                amp = _source_amp(source_kind, t, fc)
                return Ez.at[sxy[0], sxy[1]].add(amp.astype(Ez.dtype)), Hx, Hy

            return jax.lax.fori_loop(0, n, body, (Ez, Hx, Hy))

        if nframes <= 0:
            return advance(Ez, Hx, Hy, nsteps, jnp.int32(0)), None

        def frame(carry, k):
            Ez, Hx, Hy = carry
            Ez, Hx, Hy = advance(Ez, Hx, Hy, steps_per_frame, k * steps_per_frame)
            return (Ez, Hx, Hy), Ez

        (Ez, Hx, Hy), snaps = jax.lax.scan(frame, (Ez, Hx, Hy), jnp.arange(nframes))
        return (Ez, Hx, Hy), snaps

    return jax.vmap(one)(eps_batch, mu_batch, sources_xy)


def simulate_batched(eps_batch, mu_batch, config: FDTDConfig, sources_xy=None):
    """vmap-batched FDTD rollouts over a batch of scenes (surrogate datagen
    and parameter sweeps; the reference loops one simulation at a time).

    ``eps_batch``/``mu_batch``: (B, N, M); ``sources_xy``: optional (B, 2)
    int array of per-scene injection sites (defaults to config.source_xy).
    Uses the pure-JAX step (the CUDA kernel is not batched);
    returns ``(Ez, Hx, Hy)`` batched fields and batched snapshots (or None).
    """
    cfg = dataclasses.replace(config, backend="jax")
    eps_batch = jnp.asarray(eps_batch, cfg.dtype)
    mu_batch = jnp.asarray(mu_batch, cfg.dtype)
    B = eps_batch.shape[0]
    if sources_xy is None:
        sources_xy = jnp.tile(jnp.asarray(config.source_xy, jnp.int32)[None], (B, 1))
    else:
        sources_xy = jnp.asarray(sources_xy, jnp.int32)

    dt = jnp.asarray(cfg.dt, cfg.dtype)
    dx = jnp.asarray(cfg.dx, cfg.dtype)
    fc = jnp.asarray(cfg.source_fc, cfg.dtype)
    if cfg.nframes > 0:
        steps_per_frame = max(cfg.nsteps // cfg.nframes, 1)
        nframes = cfg.nsteps // steps_per_frame
    else:
        steps_per_frame, nframes = 0, 0

    return _simulate_batched_core(
        eps_batch, mu_batch, sources_xy, dt, dx, fc, nsteps=cfg.nsteps,
        nframes=nframes, steps_per_frame=steps_per_frame,
        source_kind=cfg.source_kind)
