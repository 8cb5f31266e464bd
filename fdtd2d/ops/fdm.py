"""Fast-diagonalization (FDM) preconditioner for the UPML Helmholtz operator.

For uniform (eps_ref, mu_ref) the FDFD operator *including the PML stretch*
is separable: A_ref = T_r (+) T_c - omega^2 eps_ref I (Kronecker sum), with

    T_axis = (1/mu_ref) diag(1/s) K K^T diag(1/s)      (n x n, complex)

acting along one grid axis. Eigendecomposing the two small 1D matrices once
on the host (scipy.linalg.eig; they are non-symmetric complex) gives an exact
inverse of A_ref applied as four dense matrix multiplies per call:

    Y = P_r^{-1} R P_c^{-T};  Y /= (lam_r[:,None] + lam_c[None,:] - w2e);
    X = P_r Y P_c^T

— dense matmul work for an accelerator. As a preconditioner for heterogeneous
media, the residual error comes only from the eps/mu deviation from the
reference constants, so Krylov iteration counts depend on material contrast,
not grid size or PML strength (unlike the PML-blind DST variant in
fdtd2d/fdfd/solver.py).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from fdtd2d import constants
from fdtd2d.ops.helmholtz import HelmholtzOperator, pml_sigma_profile


def _t_matrix_1d(n: int, d: float, omega: float, pml_thickness: int,
                 sigma_max: float, m: int, mu_ref: float) -> np.ndarray:
    sig = pml_sigma_profile(n, pml_thickness, sigma_max, m)
    inv_s = 1.0 / (1.0 + 1j * sig / (omega * constants.EPSILON_0))
    a = 1.0 / (2.0 * d)
    K = np.zeros((n, n))
    idx = np.arange(n - 1)
    K[idx, idx + 1] = a
    K[idx + 1, idx] = -a
    L = K @ K.T
    return (1.0 / mu_ref) * (inv_s[:, None] * L * inv_s[None, :])


@lru_cache(maxsize=16)
def _fdm_factors(n: int, d: float, omega: float, pml_thickness: int,
                 sigma_max: float, m: int, mu_ref: float):
    import scipy.linalg

    T = _t_matrix_1d(n, d, omega, pml_thickness, sigma_max, m, mu_ref)
    lam, P = scipy.linalg.eig(T)
    Pinv = np.linalg.inv(P)
    return lam, P, Pinv


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FDMPreconditioner:
    """Exact uniform-medium UPML inverse as a pytree of dense factors.

    Being a pytree, it passes through ``jit`` as a traced argument — omega
    sweeps (e.g. inverse design) reuse one compilation across frequencies.
    """

    Pr: jax.Array     # (Nx, Nx)
    Pri: jax.Array
    PcT: jax.Array    # (Ny, Ny)
    PcTi: jax.Array
    D: jax.Array      # (Nx, Ny) spectral inverse

    def __call__(self, r):
        from fdtd2d.ops.cplx import cmatmul

        Nx, Ny = self.D.shape
        shape = r.shape
        R = r.reshape(Nx, Ny).astype(self.Pr.dtype)
        Y = cmatmul(cmatmul(self.Pri, R), self.PcTi) * self.D
        return cmatmul(cmatmul(self.Pr, Y), self.PcT).reshape(shape)


def fdm_preconditioner(
    Nx: int, Ny: int, dx: float, dy: float, omega: float,
    pml_thickness: int, sigma_max: float = 2.0, m: int = 3,
    eps_ref: float = constants.EPSILON_0, mu_ref: float = constants.MU_0,
    dtype=jnp.complex64,
) -> FDMPreconditioner:
    """Build M^{-1} (exact for the uniform-medium UPML operator).

    Host-side one-time eigendecomposition (cached per parameter set).
    """
    lam_r, P_r, P_r_inv = _fdm_factors(Nx, float(dy), float(omega),
                                       pml_thickness, sigma_max, m, float(mu_ref))
    lam_c, P_c, P_c_inv = _fdm_factors(Ny, float(dx), float(omega),
                                       pml_thickness, sigma_max, m, float(mu_ref))
    denom = lam_r[:, None] + lam_c[None, :] - omega**2 * eps_ref
    from fdtd2d.ops.cplx import to_device_complex as tdc

    return FDMPreconditioner(
        Pr=tdc(P_r, dtype),
        Pri=tdc(P_r_inv, dtype),
        PcT=tdc(P_c.T, dtype),
        PcTi=tdc(P_c_inv.T, dtype),  # (P_c^T)^{-1} = (P_c^{-1})^T
        D=tdc(1.0 / denom, dtype),
    )


def fdm_preconditioner_for(op: HelmholtzOperator, **overrides) -> FDMPreconditioner:
    """FDM preconditioner matched to an operator's parameters.

    Must be called OUTSIDE jit (needs concrete omega/eps/mu for the host-side
    eigendecomposition); the returned pytree is a jit-safe argument.
    """
    Nx, Ny = op.shape
    if isinstance(jnp.asarray(op.eps), jax.core.Tracer):
        raise TypeError(
            "fdm_preconditioner_for needs a concrete operator; under "
            "jit/grad, build the FDMPreconditioner once outside the traced "
            "function and pass it via preconditioner=<M>."
        )
    eps_ref = float(np.mean(np.asarray(op.eps)))
    mu_ref = 1.0 / float(np.mean(np.asarray(op.inv_mu)))
    dx = 1.0 / (2.0 * float(op.inv_2dx))
    dy = 1.0 / (2.0 * float(op.inv_2dy))
    kw = dict(pml_thickness=op.pml_thickness, sigma_max=op.sigma_max, m=op.m,
              eps_ref=eps_ref, mu_ref=mu_ref, dtype=op.dtype)
    kw.update(overrides)
    return fdm_preconditioner(Nx, Ny, dx, dy, float(op.omega), **kw)
