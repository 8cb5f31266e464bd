"""Multi-device FDTD at kernel speed: shard_map + ppermute ghost rows around
the K-step sweep (fdtd2d/ops/kstep.py) on a 1-D row mesh.

- Each device owns ``ln = N/D`` grid rows, stored with ``K`` ghost rows on
  each side as ``(K + ln + K, M)`` in the padded layout. The sweep's
  ``[row0, row1)`` window is the own rows, so the per-device compute IS
  the single-device sweep.
- Once per K-step sweep, each device sends its first and last K own rows
  to its neighbours (``jax.lax.ppermute``; the 3 fields stacked, one
  collective per direction) and writes the rows it receives into its
  ghost rows: the sweep's halo then
  crosses device boundaries exactly as it crosses tile boundaries inside
  the kernel. Edge devices receive ppermute's zeros, and the sweep's
  ``is_top``/``is_bot`` flags (device-varying, passed as a device array)
  keep the Mur treatment on the true domain edges only.
- The source row is device-local and dynamic, so every device whose rows
  or ghost rows hold the injection adds it; each writes back only its own
  rows, so it lands exactly once.

Communication: 2 x K rows x M columns x 4 B x 3 fields per device and K
steps; over NVLink this is small next to the sweep itself.

The reference has no distributed FDTD at all (its loop is
python-src/fdtd.py:30-40, single NumPy process); SURVEY.md section 2.3 maps
this to the spatial-domain-decomposition row of the parallelism inventory.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fdtd2d.fdtd.step import MUR_BAND
from fdtd2d.ops.kstep import DEFAULT_K, IMPLS, SOURCE_KINDS, tile_plan


def plan_sharded_kstep(N: int, M: int, D: int, K: int = DEFAULT_K) -> Optional[int]:
    """The sweep depth K admitting the row decomposition, or None: rows
    must split evenly, and each device must own at least K rows (its sent
    ghost rows are own rows) and a Mur band."""
    if N % D:
        return None
    ln = N // D
    if ln < max(K, MUR_BAND + 1):
        return None
    try:
        tile_plan(ln, M, K)
    except ValueError:
        return None
    return K


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "ax", "D", "ln", "K", "kind", "sy", "nsweeps",
                     "rem", "nframes", "impl"))
def _sharded_run(ez3, hx3, hy3, ce3, ch3, fparams, sx, *, mesh, ax, D, ln, K,
                 kind, sy, nsweeps, rem, nframes, impl):
    """One jitted SPMD program: scan of (ghost exchange -> K-step sweep)."""
    sweep_fn = IMPLS[impl]
    spf_sweeps = nsweeps // max(nframes, 1) if nframes else 0

    def local_run(ez3, hx3, hy3, ce3, ch3, fparams, sx):
        ez, hx, hy = ez3[0], hx3[0], hy3[0]
        ce, ch = ce3[0], ch3[0]
        idx = jax.lax.axis_index(ax)
        flags = jnp.stack([(idx == 0), (idx == D - 1)]).astype(jnp.int32)
        # source row in this device's ghosted coords (may fall in the ghost
        # rows or outside the array entirely)
        src = jnp.stack([K + sx - idx * ln, jnp.asarray(sy, jnp.int32)]).astype(jnp.int32)

        fwd = [(i, i + 1) for i in range(D - 1)]
        bwd = [(i + 1, i) for i in range(D - 1)]

        def exchange(fields):
            """Ghost rows <- the neighbours' edge own rows, all three fields
            in one collective per direction."""
            last = jnp.stack([f[ln : K + ln] for f in fields])
            first = jnp.stack([f[K : 2 * K] for f in fields])
            if D == 1:
                from_above = from_below = jnp.zeros_like(last)
            else:
                from_above = jax.lax.ppermute(last, ax, fwd)
                from_below = jax.lax.ppermute(first, ax, bwd)
            return tuple(f.at[:K].set(a).at[K + ln :].set(b)
                         for f, a, b in zip(fields, from_above, from_below))

        def sweep(carry, t0, n):
            ez, hx, hy = exchange(carry)
            iparams = jnp.concatenate([jnp.reshape(t0, (1,)).astype(jnp.int32),
                                       src, flags])
            return sweep_fn(ez, hx, hy, ce, ch, fparams, iparams, halo=K,
                            nsteps=n, row0=K, row1=K + ln, kind=kind)

        carry = (ez, hx, hy)
        if nframes > 0:
            def frame(carry, fi):
                def body(c, j):
                    return sweep(c, (fi * spf_sweeps + j) * K, K), None

                carry, _ = jax.lax.scan(body, carry, jnp.arange(spf_sweeps))
                return carry, carry[0][K : K + ln, :]

            carry, snaps = jax.lax.scan(frame, carry, jnp.arange(nframes))
            leftover = nsweeps - nframes * spf_sweeps
        else:
            snaps = None
            leftover = nsweeps

        if leftover > 0:
            def body(c, j):
                return sweep(c, ((nsweeps - leftover) + j) * K, K), None

            carry, _ = jax.lax.scan(body, carry, jnp.arange(leftover))
        if rem > 0:
            carry = sweep(carry, jnp.asarray(nsweeps * K), rem)

        own = lambda f: f[None, K : K + ln, :]
        outs = tuple(own(f) for f in carry)
        if nframes > 0:
            return outs + (snaps[:, None],)
        return outs

    spec = P(ax, None, None)
    out_specs = (spec, spec, spec)
    if nframes > 0:
        out_specs = out_specs + (P(None, ax, None, None),)
    # check_vma=False: the FFI call's result carries no varying-manual-axes
    # annotation, which the vma type check rejects inside shard_map; the
    # computation is sound (each device steps only its own ghosted block).
    f = shard_map(local_run, mesh=mesh,
                  in_specs=(spec, spec, spec, spec, spec, P(), P()),
                  out_specs=out_specs, check_vma=False)
    return f(ez3, hx3, hy3, ce3, ch3, fparams, sx)


@functools.partial(jax.jit, static_argnames=("D", "ln", "K"))
def _prep(eps, mu, Ez, Hx, Hy, dt, dx, fc, *, D, ln, K):
    """Coefficients + overlapped ghosted row blocks as ONE program."""
    from fdtd2d.fdtd.step import precompute_coefficients
    from fdtd2d.ops.kstep import to_padded_layout

    N, M = eps.shape
    ce, ch, coef = precompute_coefficients(eps, mu, dt, dx, jnp.float32)
    Hx, Hy, ce, ch = to_padded_layout(Hx, Hy, ce, ch, (N, M))

    def ghost_stack(a):
        """(D, K + ln + K, M): device d's own rows plus K rows of context
        each side (true neighbour values for the coefficients and the
        initial fields; zeros beyond the domain)."""
        g = jnp.pad(a, ((K, K), (0, 0)))
        return jnp.stack([g[d * ln : d * ln + ln + 2 * K] for d in range(D)])

    fparams = jnp.stack([coef, jnp.asarray(dt, jnp.float32),
                         jnp.asarray(fc, jnp.float32)])
    return (*(ghost_stack(a) for a in (Ez, Hx, Hy, ce, ch)), fparams)


def simulate_sharded_kstep(eps, mu, config, mesh: Mesh, state=None,
                           impl: str = "cuda"):
    """FDTD rollout row-sharded over a 1-D mesh, each device running the
    K-step sweep on its row block (see module docstring).

    Returns ``((Ez, Hx, Hy), snapshots)`` with the single-device staggered
    shapes; snapshots is (nframes, N, M) or None (frame boundaries land on
    K-step sweep multiples). ``impl="reference"`` runs the plain-JAX sweep
    in place of the CUDA kernel (what the CPU tests exercise). Raises if the
    shape does not admit the decomposition (:func:`plan_sharded_kstep`)."""
    dtype = jnp.float32
    N, M = jnp.asarray(eps).shape
    assert mesh.devices.ndim == 1, "the kstep sharding uses a 1-D (row) mesh"
    D = mesh.devices.shape[0]
    ax = mesh.axis_names[0]
    K = plan_sharded_kstep(N, M, D)
    if K is None:
        raise ValueError(f"grid {N}x{M} over {D} devices admits no kstep row "
                         "decomposition")
    ln = N // D

    rowsh = NamedSharding(mesh, P(ax, None))
    rput = lambda a: jax.device_put(jnp.asarray(a, dtype), rowsh)
    if state is None:
        state = (jnp.zeros((N, M), dtype), jnp.zeros((N, M - 1), dtype),
                 jnp.zeros((N - 1, M), dtype))
    Ez, Hx, Hy = state
    # Hy's staggered (N-1, M) rows shard unevenly over D: pad to N rows (the
    # pad row only feeds coefficient-masked updates)
    Hy = jnp.pad(jnp.asarray(Hy, dtype), ((0, N - Hy.shape[0]), (0, 0)))
    ez3, hx3, hy3, ce3, ch3, fparams = _prep(
        rput(eps), rput(mu), rput(Ez), rput(Hx), rput(Hy),
        jnp.asarray(config.dt, dtype), jnp.asarray(config.dx, dtype),
        jnp.asarray(config.source_fc, dtype), D=D, ln=ln, K=K)
    sh = NamedSharding(mesh, P(ax, None, None))
    ez3, hx3, hy3, ce3, ch3 = (jax.device_put(a, sh)
                               for a in (ez3, hx3, hy3, ce3, ch3))
    rep = NamedSharding(mesh, P())
    fparams = jax.device_put(fparams, rep)
    sx = jax.device_put(jnp.asarray(config.source_xy[0], jnp.int32), rep)

    nsweeps, rem = divmod(config.nsteps, K)
    nframes = min(config.nframes, nsweeps) if config.nframes > 0 else 0
    out = _sharded_run(
        ez3, hx3, hy3, ce3, ch3, fparams, sx, mesh=mesh, ax=ax, D=D, ln=ln,
        K=K, kind=SOURCE_KINDS.index(config.source_kind),
        sy=config.source_xy[1], nsweeps=nsweeps, rem=rem, nframes=nframes,
        impl=impl)
    ez, hx, hy = (o.reshape(N, M) for o in out[:3])
    snaps = out[3].reshape(-1, N, M) if nframes > 0 else None
    return (ez, hx[:, : M - 1], hy[: N - 1, :]), snaps
