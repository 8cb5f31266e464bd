"""Matrix-free FDFD Helmholtz operator with UPML (complex coordinate stretch).

The reference assembles a sparse "outrigger" matrix with Kronecker products
and solves it directly (reference: python-src/fdfd.py:14-61 + scipy spsolve).
Sparse direct factorization does not map to an accelerator; instead the operator is
applied matrix-free as a fused 5-point distance-2 stencil, feeding iterative
Krylov solvers (fdtd2d/fdfd/solver.py).

Operator (equal to the reference's matrix on square grids, which is all the
reference ever builds — its kron axis convention is only self-consistent
there; here the axis semantics are fixed for any (Nx, Ny)):

    A = C_c M_mu C_c^T + C_r M_mu C_r^T - omega^2 M_eps
    C_c = diag(1/s_c) K_c,   C_r = diag(1/s_r) K_r

where K_c / K_r are central differences along the column / row axis of the
(Nx, Ny) field (zero-truncated at the boundary), M_mu = diag(1/mu),
M_eps = diag(eps), and s are polynomial-profile PML stretch factors
s = 1 + i sigma / (omega eps0) (reference: python-src/fdfd.py:16-38).
Since K^T = -K, the apply is

    A x = -(1/s_c) K_c[(1/mu) K_c((1/s_c) x)]
          -(1/s_r) K_r[(1/mu) K_r((1/s_r) x)] - omega^2 eps x.

The operator is a registered pytree, so it jits, vmaps (batched solves for
surrogate datagen), and shards (grid axes over a device mesh) cleanly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fdtd2d import constants


def pml_sigma_profile(n: int, pml_thickness: int, sigma_max: float, m: int) -> np.ndarray:
    """1D polynomial PML conductivity profile (reference fdfd.py:16-30)."""
    sigma = np.zeros(n)
    if pml_thickness > 0:
        ramp = (np.arange(pml_thickness) / pml_thickness) ** m
        sigma[:pml_thickness] = sigma_max * ramp[::-1]
        sigma[n - pml_thickness :] = sigma_max * ramp
    return sigma


def stretch_factors(Nx: int, Ny: int, omega: float, pml_thickness: int,
                    sigma_max: float, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """(s_row (Nx,), s_col (Ny,)): complex PML stretch factors per axis."""
    sig_r = pml_sigma_profile(Nx, pml_thickness, sigma_max, m)
    sig_c = pml_sigma_profile(Ny, pml_thickness, sigma_max, m)
    s_r = 1.0 + 1j * sig_r / (omega * constants.EPSILON_0)
    s_c = 1.0 + 1j * sig_c / (omega * constants.EPSILON_0)
    return s_r, s_c


def _dcol(f, inv2d):
    """Central difference along axis 1, zero-truncated: (f[:,j+1]-f[:,j-1])*inv2d."""
    fp = jnp.pad(f[:, 1:], ((0, 0), (0, 1)))
    fm = jnp.pad(f[:, :-1], ((0, 0), (1, 0)))
    return (fp - fm) * inv2d


def _drow(f, inv2d):
    """Central difference along axis 0, zero-truncated."""
    fp = jnp.pad(f[1:, :], ((0, 1), (0, 0)))
    fm = jnp.pad(f[:-1, :], ((1, 0), (0, 0)))
    return (fp - fm) * inv2d


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HelmholtzOperator:
    """Matrix-free A for the 2D TE FDFD problem on an (Nx, Ny) grid."""

    eps: jax.Array          # (Nx, Ny) real
    inv_mu: jax.Array       # (Nx, Ny) real
    inv_s_row: jax.Array    # (Nx,) complex — 1/s along the row axis
    inv_s_col: jax.Array    # (Ny,) complex — 1/s along the column axis
    omega: jax.Array        # scalar
    inv_2dx: jax.Array      # scalar: 1/(2*dx), column-axis spacing
    inv_2dy: jax.Array      # scalar: 1/(2*dy), row-axis spacing
    # static PML metadata (carried so preconditioners can be rebuilt)
    pml_thickness: int = dataclasses.field(default=40, metadata=dict(static=True))
    sigma_max: float = dataclasses.field(default=2.0, metadata=dict(static=True))
    m: int = dataclasses.field(default=3, metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return self.eps.shape

    @property
    def dtype(self):
        return self.inv_s_row.dtype

    def apply(self, x: jax.Array) -> jax.Array:
        """A @ x for x of shape (Nx, Ny) (complex)."""
        isc = self.inv_s_col[None, :]
        isr = self.inv_s_row[:, None]
        tc = _dcol(x * isc, self.inv_2dx)
        tc = _dcol(tc * self.inv_mu, self.inv_2dx) * isc
        tr = _drow(x * isr, self.inv_2dy)
        tr = _drow(tr * self.inv_mu, self.inv_2dy) * isr
        return -(tc + tr) - (self.omega**2) * self.eps * x

    def __call__(self, x: jax.Array) -> jax.Array:
        """Flattened matvec (for Krylov drivers operating on vectors)."""
        if x.ndim == 1:
            return self.apply(x.reshape(self.shape)).ravel()
        return self.apply(x)

    def diagonal(self) -> jax.Array:
        """diag(A) as an (Nx, Ny) array (for Jacobi preconditioning)."""
        a_c = self.inv_2dx**2
        a_r = self.inv_2dy**2
        im = self.inv_mu
        # (C M C^T)[k,k] = (1/s_k)^2 * a * (1/mu_{k-1} + 1/mu_{k+1}), truncated.
        im_cm = jnp.pad(im[:, :-1], ((0, 0), (1, 0)))  # 1/mu at col j-1 (0 at edge)
        im_cp = jnp.pad(im[:, 1:], ((0, 0), (0, 1)))   # 1/mu at col j+1
        im_rm = jnp.pad(im[:-1, :], ((1, 0), (0, 0)))
        im_rp = jnp.pad(im[1:, :], ((0, 1), (0, 0)))
        dc = (self.inv_s_col[None, :] ** 2) * a_c * (im_cm + im_cp)
        dr = (self.inv_s_row[:, None] ** 2) * a_r * (im_rm + im_rp)
        return dc + dr - (self.omega**2) * self.eps


def make_operator(eps, mu, dx, dy, omega, pml_thickness: int = 40,
                  sigma_max: float = 2.0, m: int = 3,
                  dtype=jnp.complex64) -> HelmholtzOperator:
    """Build the matrix-free operator (defaults match reference fdfd.py:14)."""
    eps = jnp.asarray(eps)
    mu = jnp.asarray(mu)
    Nx, Ny = eps.shape
    s_r, s_c = stretch_factors(Nx, Ny, float(omega), pml_thickness, sigma_max, m)
    from fdtd2d.ops.cplx import to_device_complex as tdc

    # the real dtype is resolved host-side (no 0-d complex device array)
    real = jnp.finfo(dtype).dtype
    return HelmholtzOperator(
        eps=eps.astype(real),
        inv_mu=(1.0 / mu).astype(real),
        inv_s_row=tdc(1.0 / s_r, dtype),
        inv_s_col=tdc(1.0 / s_c, dtype),
        omega=jnp.asarray(omega, real),
        inv_2dx=jnp.asarray(1.0 / (2.0 * dx), real),
        inv_2dy=jnp.asarray(1.0 / (2.0 * dy), real),
        pml_thickness=pml_thickness,
        sigma_max=sigma_max,
        m=m,
    )
