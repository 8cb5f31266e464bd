"""Split-complex float64 arithmetic for high-precision residuals.

Written for a backend that executes float64 elementwise ops but compiles no
complex128 program; on a GPU complex128 compiles, and ROADMAP C2 decides
with measurements whether this module stays. The mixed-precision machinery
represents high-precision complex
fields as explicit (real, imag) float64 pairs and implements the Helmholtz
apply on the pair directly.

Used by the iterative-refinement drivers (fdtd2d/fdfd/solver.py,
fdtd2d/fdfd/tiled.py): the correction solves run in complex64 (fast,
attainable residual limited to ~||A|| ||x|| / ||b|| * 2^-24), while the
outer residual r = b - A x is evaluated here in f64, pushing the TRUE
relative residual to the f64 floor instead of the c64 one.

float64 arrays require ``jax.config jax_enable_x64``; the drivers enable it
process-wide on first use (safe for the rest of this package: every runtime
array here is dtype-explicit).

Reference semantics: the operator equals fdtd2d/ops/helmholtz.py's apply
(itself the matrix-free form of the reference's make_A, reference:
python-src/fdfd.py:14-61) evaluated in float64.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from fdtd2d.ops.helmholtz import HelmholtzOperator, stretch_factors


def require_x64() -> None:
    """Enable 64-bit mode (idempotent; needed for f64 arrays on any backend)."""
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)


class Split(NamedTuple):
    """A complex array as an explicit (re, im) pair of real arrays."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    def astype(self, dtype) -> "Split":
        return Split(self.re.astype(dtype), self.im.astype(dtype))


def split_from_complex(z: jax.Array, dtype=jnp.float64) -> Split:
    return Split(jnp.real(z).astype(dtype), jnp.imag(z).astype(dtype))


def split_to_complex(s: Split, dtype=jnp.complex64) -> jax.Array:
    real = jnp.finfo(dtype).dtype
    return jax.lax.complex(s.re.astype(real), s.im.astype(real))


def split_from_numpy(z, dtype=jnp.float64) -> Split:
    z = np.asarray(z)
    return Split(jnp.asarray(np.ascontiguousarray(z.real), dtype),
                 jnp.asarray(np.ascontiguousarray(z.imag), dtype))


@jax.jit
def snorm(s: Split) -> jax.Array:
    """Overflow-safe 2-norm. Where float64 is emulated as float32 PAIRS
    (extended mantissa, f32 EXPONENT range ~1e38) the naive
    sum-of-squares overflows to inf for entries past ~1e19 — e.g. an FDFD
    right-hand side b = -1j*omega*src at omega ~ 1e10 applied twice.
    Factoring out max|.| keeps every square O(1). Jitted: several of the
    eager f64 scalar ops involved are UNIMPLEMENTED on this backend, while
    the compiled program runs fine (the usual rule here — see ops/cplx.py)."""
    m = jnp.maximum(jnp.max(jnp.abs(s.re)), jnp.max(jnp.abs(s.im)))
    safe = jnp.where(m == 0, 1.0, m)
    return m * jnp.sqrt(jnp.sum((s.re / safe) ** 2 + (s.im / safe) ** 2))


@jax.jit
def snorm_batched(s: Split) -> jax.Array:
    """Per-sample overflow-safe 2-norms of a (B, Nx, Ny) Split (see
    :func:`snorm` for why naive sums of squares can overflow an f32-pair
    emulated f64 range, and why it is jitted)."""
    m = jnp.maximum(jnp.max(jnp.abs(s.re), axis=(1, 2)),
                    jnp.max(jnp.abs(s.im), axis=(1, 2)))
    safe = jnp.where(m == 0, 1.0, m)[:, None, None]
    return m * jnp.sqrt(jnp.sum((s.re / safe) ** 2 + (s.im / safe) ** 2,
                                axis=(1, 2)))


def saxpy(alpha: jax.Array, x: Split, y: Split) -> Split:
    """y + alpha * x with real scalar alpha (f64)."""
    return Split(y.re + alpha * x.re, y.im + alpha * x.im)


def ssub(x: Split, y: Split) -> Split:
    return Split(x.re - y.re, x.im - y.im)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _dcol(f, inv2d):
    fp = jnp.pad(f[:, 1:], ((0, 0), (0, 1)))
    fm = jnp.pad(f[:, :-1], ((0, 0), (1, 0)))
    return (fp - fm) * inv2d


def _drow(f, inv2d):
    fp = jnp.pad(f[1:, :], ((0, 1), (0, 0)))
    fm = jnp.pad(f[:-1, :], ((1, 0), (0, 0)))
    return (fp - fm) * inv2d


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HelmholtzF64:
    """The FDFD Helmholtz operator with all parameters in float64, applied to
    split-complex fields. Semantics identical to HelmholtzOperator.apply
    (fdtd2d/ops/helmholtz.py:100-108)."""

    eps: jax.Array       # (Nx, Ny) f64
    inv_mu: jax.Array    # (Nx, Ny) f64
    isr: Split           # (Nx,) 1/s row
    isc: Split           # (Ny,) 1/s col
    omega2: jax.Array    # scalar f64: omega^2
    inv_2dx: jax.Array   # scalar f64
    inv_2dy: jax.Array   # scalar f64

    @property
    def shape(self) -> Tuple[int, int]:
        return self.eps.shape

    def apply(self, x: Split) -> Split:
        iscr, isci = self.isc.re[None, :], self.isc.im[None, :]
        isrr, isri = self.isr.re[:, None], self.isr.im[:, None]
        # column term: (1/s_c) Kc [ (1/mu) Kc ((1/s_c) x) ]
        tr, ti = _cmul(x.re, x.im, iscr, isci)
        tr, ti = _dcol(tr, self.inv_2dx), _dcol(ti, self.inv_2dx)
        tr, ti = tr * self.inv_mu, ti * self.inv_mu
        tr, ti = _dcol(tr, self.inv_2dx), _dcol(ti, self.inv_2dx)
        tcr, tci = _cmul(tr, ti, iscr, isci)
        # row term
        tr, ti = _cmul(x.re, x.im, isrr, isri)
        tr, ti = _drow(tr, self.inv_2dy), _drow(ti, self.inv_2dy)
        tr, ti = tr * self.inv_mu, ti * self.inv_mu
        tr, ti = _drow(tr, self.inv_2dy), _drow(ti, self.inv_2dy)
        trr, tri = _cmul(tr, ti, isrr, isri)
        we = self.omega2 * self.eps
        return Split(-(tcr + trr) - we * x.re, -(tci + tri) - we * x.im)

    def residual(self, b: Split, x: Split) -> Split:
        ax = self.apply(x)
        return Split(b.re - ax.re, b.im - ax.im)


def make_operator_f64(eps, mu, dx, dy, omega, pml_thickness: int = 40,
                      sigma_max: float = 2.0, m: int = 3) -> HelmholtzF64:
    """Build the f64 split-complex operator from host-side scene arrays."""
    require_x64()
    eps = np.asarray(eps, np.float64)
    mu = np.asarray(mu, np.float64)
    Nx, Ny = eps.shape
    s_r, s_c = stretch_factors(Nx, Ny, float(omega), pml_thickness, sigma_max, m)
    return HelmholtzF64(
        eps=jnp.asarray(eps),
        inv_mu=jnp.asarray(1.0 / mu),
        isr=split_from_numpy(1.0 / s_r),
        isc=split_from_numpy(1.0 / s_c),
        omega2=jnp.asarray(float(omega) ** 2, jnp.float64),
        inv_2dx=jnp.asarray(1.0 / (2.0 * float(dx)), jnp.float64),
        inv_2dy=jnp.asarray(1.0 / (2.0 * float(dy)), jnp.float64),
    )


def f64_operator_for(op: HelmholtzOperator) -> HelmholtzF64:
    """f64 twin of a concrete c64/c128 HelmholtzOperator (outside jit)."""
    require_x64()
    dx = 1.0 / (2.0 * float(op.inv_2dx))
    dy = 1.0 / (2.0 * float(op.inv_2dy))
    return make_operator_f64(
        np.asarray(op.eps), 1.0 / np.asarray(op.inv_mu), dx, dy,
        float(op.omega), op.pml_thickness, op.sigma_max, op.m)
