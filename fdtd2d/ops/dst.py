"""DST-I transforms via FFT (XLA-native).

Used by the shifted-Laplacian FDFD preconditioner (fdtd2d/fdfd/solver.py):
the constant-coefficient distance-2 Helmholtz stencil is (approximately)
diagonalized by the type-I discrete sine transform, giving an O(N^2 log N)
inverse via two FFTs per axis. scipy.fft.dst does not exist inside jit; this
builds DST-I from ``jnp.fft.fft`` of the odd extension.

DST-I convention: S[k] = sum_j f[j] sin(pi (j+1)(k+1) / (n+1)); the transform
is its own inverse up to a factor 2/(n+1).
"""

from __future__ import annotations

import jax.numpy as jnp


def dst1(f: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Type-I DST along ``axis`` (complex or real input, complex output)."""
    f = jnp.moveaxis(f, axis, -1)
    n = f.shape[-1]
    zeros = jnp.zeros(f.shape[:-1] + (1,), f.dtype)
    ext = jnp.concatenate([zeros, f, zeros, -f[..., ::-1]], axis=-1)  # length 2(n+1)
    G = jnp.fft.fft(ext, axis=-1)
    S = 0.5j * G[..., 1 : n + 1]
    return jnp.moveaxis(S, -1, axis)


def idst1(S: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Inverse of :func:`dst1`."""
    n = S.shape[axis]
    return dst1(S, axis=axis) * (2.0 / (n + 1))


def dst2d(f: jnp.ndarray) -> jnp.ndarray:
    return dst1(dst1(f, axis=-1), axis=-2)


def idst2d(S: jnp.ndarray) -> jnp.ndarray:
    return idst1(idst1(S, axis=-1), axis=-2)
