"""Pure-JAX TE-mode leapfrog step (functional, jittable, vmappable).

Same staged semantics as the NumPy oracle (fdtd2d/fdtd/reference.py,
derived from reference python-src/main.py:12-76): H-update, interior Ez
update, 5-cell Mur bands (left/right then top/bottom), corner averaging.

Coefficient arrays are precomputed once (``ce = dt/(eps*dx)``,
``ch = dt/(mu[:-1,:-1]*dx)``) so the scanned step body carries no divisions —
the reference divides by material arrays every step (python-src/main.py:27,73).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

MUR_BAND = 5


def mur_coefficient(eps00, mu00, dt, dx):
    c = 1.0 / jnp.sqrt(mu00 * eps00)
    return (c * dt - dx) / (c * dt + dx)


def precompute_coefficients(eps, mu, dt, dx, dtype=jnp.float32):
    """(ce, ch, coef): update coefficients and the scalar Mur coefficient."""
    eps = jnp.asarray(eps)
    mu = jnp.asarray(mu)
    ce = (dt / (eps * dx)).astype(dtype)
    ch = (dt / (mu[:-1, :-1] * dx)).astype(dtype)
    coef = mur_coefficient(eps[0, 0], mu[0, 0], dt, dx).astype(dtype)
    return ce, ch, coef


def fdtd_step_padded(
    Ez: jax.Array,
    Hx: jax.Array,
    Hy: jax.Array,
    ce: jax.Array,
    ch: jax.Array,
    coef: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Leapfrog step with all fields padded to a common (N, M) shape.

    Same semantics as :func:`fdtd_step`; Hx's phantom last column and Hy's
    phantom last row are never read or written. Used by the sharded path —
    uniform shapes shard evenly over a device mesh (the staggered N x N-1
    shapes force uneven GSPMD partitions, which XLA mishandles at shard
    boundaries), and by the K-step CUDA kernel (same layout, see
    fdtd2d/ops/kstep.py).
    """
    b = MUR_BAND
    N, M = Ez.shape

    e00 = Ez[: N - 1, : M - 1]
    chv = ch[: N - 1, : M - 1]
    Hx = Hx.at[: N - 1, : M - 1].add(-chv * (Ez[1:, : M - 1] - e00))
    Hy = Hy.at[: N - 1, : M - 1].add(chv * (Ez[: N - 1, 1:] - e00))

    P = Ez
    curl_h = (Hy[1 : N - 1, 1 : M - 1] - Hy[1 : N - 1, 0 : M - 2]) - (
        Hx[1 : N - 1, 1 : M - 1] - Hx[0 : N - 2, 1 : M - 1]
    )
    E = P.at[1:-1, 1:-1].add(curl_h * ce[1:-1, 1:-1])

    E2 = E.at[1:-1, 0:b].set(P[1:-1, 1 : b + 1] + coef * (E[1:-1, 1 : b + 1] - P[1:-1, 0:b]))
    E2 = E2.at[1:-1, -b:].set(P[1:-1, -b - 1 : -1] + coef * (E[1:-1, -b - 1 : -1] - P[1:-1, -b:]))
    E3 = E2.at[0:b, 1:-1].set(P[1 : b + 1, 1:-1] + coef * (E2[1 : b + 1, 1:-1] - P[0:b, 1:-1]))
    E3 = E3.at[-b:, 1:-1].set(P[-b - 1 : -1, 1:-1] + coef * (E2[-b - 1 : -1, 1:-1] - P[-b:, 1:-1]))
    E4 = E3.at[0:b, 0:b].set((E3[0:b, 1 : b + 1] + E3[1 : b + 1, 0:b]) * 0.5)
    E4 = E4.at[0:b, -b:].set((E3[0:b, -b - 1 : -1] + E3[1 : b + 1, -b:]) * 0.5)
    E4 = E4.at[-b:, 0:b].set((E3[-b - 1 : -1, 0:b] + E3[-b:, 1 : b + 1]) * 0.5)
    E4 = E4.at[-b:, -b:].set((E3[-b - 1 : -1, -b:] + E3[-b:, -b - 1 : -1]) * 0.5)
    return E4, Hx, Hy


def fdtd_step(
    Ez: jax.Array,
    Hx: jax.Array,
    Hy: jax.Array,
    ce: jax.Array,
    ch: jax.Array,
    coef: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One leapfrog step. Shapes: Ez (N,M), Hx (N,M-1), Hy (N-1,M)."""
    b = MUR_BAND

    # -- H update (staggered curl of Ez) ------------------------------------
    Hx = Hx.at[:-1, :].add(-ch * (Ez[1:, :-1] - Ez[:-1, :-1]))
    Hy = Hy.at[:, :-1].add(ch * (Ez[:-1, 1:] - Ez[:-1, :-1]))

    # -- Ez interior update --------------------------------------------------
    P = Ez  # pre-update field, consumed by the Mur scheme
    curl_h = (Hy[1:, 1:-1] - Hy[1:, :-2]) - (Hx[1:-1, 1:] - Hx[:-2, 1:])
    E = P.at[1:-1, 1:-1].add(curl_h * ce[1:-1, 1:-1])

    # -- Mur bands: left/right, then top/bottom ------------------------------
    E2 = E.at[1:-1, 0:b].set(P[1:-1, 1 : b + 1] + coef * (E[1:-1, 1 : b + 1] - P[1:-1, 0:b]))
    E2 = E2.at[1:-1, -b:].set(P[1:-1, -b - 1 : -1] + coef * (E[1:-1, -b - 1 : -1] - P[1:-1, -b:]))

    E3 = E2.at[0:b, 1:-1].set(P[1 : b + 1, 1:-1] + coef * (E2[1 : b + 1, 1:-1] - P[0:b, 1:-1]))
    E3 = E3.at[-b:, 1:-1].set(P[-b - 1 : -1, 1:-1] + coef * (E2[-b - 1 : -1, 1:-1] - P[-b:, 1:-1]))

    # -- corner averaging -----------------------------------------------------
    E4 = E3.at[0:b, 0:b].set((E3[0:b, 1 : b + 1] + E3[1 : b + 1, 0:b]) * 0.5)
    E4 = E4.at[0:b, -b:].set((E3[0:b, -b - 1 : -1] + E3[1 : b + 1, -b:]) * 0.5)
    E4 = E4.at[-b:, 0:b].set((E3[-b - 1 : -1, 0:b] + E3[-b:, 1 : b + 1]) * 0.5)
    E4 = E4.at[-b:, -b:].set((E3[-b - 1 : -1, -b:] + E3[-b:, -b - 1 : -1]) * 0.5)

    return E4, Hx, Hy
