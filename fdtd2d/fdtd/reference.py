"""NumPy golden-oracle FDTD step (float64, CPU).

This is the fidelity anchor of the whole FDTD stack: the JAX step, the CUDA
kernel's plain reference, and the sharded step are each tested against it (<= 1e-5 relative
field error), generalizing the reference repo's scipy-vs-JAX parity-testing
pattern (reference: python-src/test_jax_fdfd.py:37-47).

Semantics reproduce the reference kernels exactly (reference:
python-src/main.py:12-76): TE-mode leapfrog on a staggered Yee grid, 5-cell
first-order Mur absorbing bands on all four edges, and 5x5 corner averaging.
The reference applies the boundary bands with sequential Python loops; the
loop-carried reads there always see pre-loop values, so each band vectorizes
into one slice assignment — done in four stages below (interior, left+right,
top+bottom, corners), each stage reading the previous stage's output, which
reproduces the sequential update order bit-for-bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MUR_BAND = 5  # boundary band width in cells


def mur_coefficient(eps00: float, mu00: float, dt: float, dx: float) -> float:
    """First-order Mur coefficient (c*dt - dx)/(c*dt + dx), c from the [0,0] cell."""
    c = 1.0 / np.sqrt(mu00 * eps00)
    return (c * dt - dx) / (c * dt + dx)


def numpy_step(
    Ez: np.ndarray,
    Hx: np.ndarray,
    Hy: np.ndarray,
    eps: np.ndarray,
    mu: np.ndarray,
    dt: float,
    dx: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One functional leapfrog step: H-update then E-update with Mur ABC."""
    b = MUR_BAND
    assert Ez.shape[0] >= 3 * b and Ez.shape[1] >= 3 * b, "grid too small for Mur bands"

    Hx = Hx.copy()
    Hy = Hy.copy()
    ch = dt / (mu[:-1, :-1] * dx)
    Hx[:-1, :] -= ch * (Ez[1:, :-1] - Ez[:-1, :-1])
    Hy[:, :-1] += ch * (Ez[:-1, 1:] - Ez[:-1, :-1])

    P = Ez  # field before this E-update (the Mur scheme's "previous" state)
    E = Ez.copy()
    curl_h = (Hy[1:, 1:-1] - Hy[1:, :-2]) - (Hx[1:-1, 1:] - Hx[:-2, 1:])
    E[1:-1, 1:-1] = P[1:-1, 1:-1] + curl_h * (dt / (eps[1:-1, 1:-1] * dx))

    coef = mur_coefficient(eps[0, 0], mu[0, 0], dt, dx)

    # Stage 2: left/right bands (read post-interior values).
    E2 = E.copy()
    E2[1:-1, 0:b] = P[1:-1, 1 : b + 1] + coef * (E[1:-1, 1 : b + 1] - P[1:-1, 0:b])
    E2[1:-1, -b:] = P[1:-1, -b - 1 : -1] + coef * (E[1:-1, -b - 1 : -1] - P[1:-1, -b:])

    # Stage 3: top/bottom bands (read post-left/right values).
    E3 = E2.copy()
    E3[0:b, 1:-1] = P[1 : b + 1, 1:-1] + coef * (E2[1 : b + 1, 1:-1] - P[0:b, 1:-1])
    E3[-b:, 1:-1] = P[-b - 1 : -1, 1:-1] + coef * (E2[-b - 1 : -1, 1:-1] - P[-b:, 1:-1])

    # Stage 4: corner averaging (reads post-boundary values).
    E4 = E3.copy()
    E4[0:b, 0:b] = (E3[0:b, 1 : b + 1] + E3[1 : b + 1, 0:b]) / 2.0
    E4[0:b, -b:] = (E3[0:b, -b - 1 : -1] + E3[1 : b + 1, -b:]) / 2.0
    E4[-b:, 0:b] = (E3[-b - 1 : -1, 0:b] + E3[-b:, 1 : b + 1]) / 2.0
    E4[-b:, -b:] = (E3[-b - 1 : -1, -b:] + E3[-b:, -b - 1 : -1]) / 2.0

    return E4, Hx, Hy


def numpy_simulate(
    eps: np.ndarray,
    mu: np.ndarray,
    dt: float,
    dx: float,
    nsteps: int,
    source_xy: Tuple[int, int],
    source_fc: float,
    source_kind: str = "ricker",
) -> np.ndarray:
    """Run a full rollout with additive point-source injection; returns Ez.

    Step order matches the reference driver (reference: python-src/fdtd.py:30-34):
    H-update, E-update, then source injection at time i*dt.
    """
    rows, cols = eps.shape
    Ez = np.zeros((rows, cols))
    Hx = np.zeros((rows, cols - 1))
    Hy = np.zeros((rows - 1, cols))
    x, y = source_xy
    for i in range(nsteps):
        Ez, Hx, Hy = numpy_step(Ez, Hx, Hy, eps, mu, dt, dx)
        t = i * dt
        if source_kind == "ricker":
            tau = np.pi * source_fc * (t - 1.0 / source_fc)
            amp = (1.0 - 2.0 * tau**2) * np.exp(-(tau**2))
        else:
            env = 1.0 - np.exp(-((t - 3000.0 / source_fc) ** 2) / (2.0 * (2.0 / source_fc) ** 2))
            amp = env * np.sin(2.0 * np.pi * source_fc * t)
        Ez[x, y] += amp
    return Ez
