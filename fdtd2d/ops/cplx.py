"""Complex contraction helpers built from real contractions.

The solvers express complex ``@``, ``vdot``, norms and transfers through
real arrays and real contractions at explicit HIGHEST precision. They were
written for a backend without complex contractions; on a GPU complex
``dot_general`` compiles, and ROADMAP C3 decides with measurements whether
these helpers stay.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def to_device_complex(x, dtype=jnp.complex64) -> jax.Array:
    """Host -> device transfer of a complex array via its real/imag parts.

    Real transfers + an on-device ``lax.complex`` halve the bytes when
    downcasting c128 -> c64 on the host side of the transfer.
    """
    import numpy as np

    x = np.asarray(x)
    real = jnp.finfo(dtype).dtype  # resolved host-side, no 0-d device array
    if not np.iscomplexobj(x):
        z = jnp.asarray(x.astype(real))
        return jax.lax.complex(z, jnp.zeros_like(z))
    re = jnp.asarray(np.ascontiguousarray(x.real).astype(real))
    im = jnp.asarray(np.ascontiguousarray(x.imag).astype(real))
    return jax.lax.complex(re, im)


def cgather(a: jax.Array, *idx) -> jax.Array:
    """Fancy-index a complex array via separate real/imag gathers."""
    if not jnp.iscomplexobj(a):
        return a[tuple(idx)]
    return jax.lax.complex(jnp.real(a)[tuple(idx)], jnp.imag(a)[tuple(idx)])


def czeros(shape, dtype=jnp.complex64) -> jax.Array:
    """Eager complex zeros via lax.complex of real zeros."""
    real = jnp.finfo(dtype).dtype
    z = jnp.zeros(shape, real)
    return jax.lax.complex(z, z)


def fetch_complex(x: jax.Array):
    """Device -> host transfer of a complex array via its real/imag parts."""
    import numpy as np

    return np.asarray(jnp.real(x)) + 1j * np.asarray(jnp.imag(x))


def cdot(a: jax.Array, b: jax.Array) -> jax.Array:
    """<a, b> = sum(conj(a) * b) without a complex dot_general."""
    ar, ai = jnp.real(a), jnp.imag(a)
    br, bi = jnp.real(b), jnp.imag(b)
    re = jnp.sum(ar * br + ai * bi)
    if not jnp.iscomplexobj(a) and not jnp.iscomplexobj(b):
        return re
    im = jnp.sum(ar * bi - ai * br)
    return jax.lax.complex(re, im)


def cnorm(a: jax.Array) -> jax.Array:
    """||a||_2 as a real scalar (complex-safe)."""
    return jnp.sqrt(jnp.sum(jnp.real(a) ** 2 + jnp.imag(a) ** 2))


def cmatmul(A: jax.Array, B: jax.Array) -> jax.Array:
    """A @ B via four real matmuls when either operand is complex.

    Uses HIGHEST matmul precision: a default f32 matmul may run in TF32 on
    a GPU, which destroys preconditioner quality and Krylov recurrences.
    """
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    if not (jnp.iscomplexobj(A) or jnp.iscomplexobj(B)):
        return mm(A, B)
    Ar, Ai = jnp.real(A), jnp.imag(A)
    Br, Bi = jnp.real(B), jnp.imag(B)
    re = mm(Ar, Br) - mm(Ai, Bi)
    im = mm(Ar, Bi) + mm(Ai, Br)
    return jax.lax.complex(re, im)
