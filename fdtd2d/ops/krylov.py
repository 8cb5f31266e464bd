"""Right-preconditioned restarted GMRES, jit/vmap/shard-friendly.

Written in-house because ``jax.scipy.sparse.linalg.gmres`` mishandles the
preconditioned complex-symmetric Helmholtz system (returns x=0), and because
the sharded solver (fdtd2d/parallel/) needs full control over where the
global reductions (dot products) happen.

Numerics (matter in float32/complex64):
- modified Gram-Schmidt with one reorthogonalization pass (MGS2) -- single-
  pass MGS loses orthogonality and stalls the restart cycles in f32,
- the small least-squares problem is solved by incremental complex Givens
  rotations (QR), not normal equations (which square the condition number),
- complex contractions are expressed through real ones (ops/cplx) and small
  matmuls run at HIGHEST precision (a GPU may run f32 matmuls in TF32).

Right preconditioning solves A M^{-1} u = b, x = M^{-1} u, so convergence is
measured on the TRUE residual, independent of the preconditioner\'s scaling.
Since the preconditioned vectors Z_j are stored (flexible GMRES), variable/
nonlinear preconditioners are also supported.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from fdtd2d.ops.cplx import cdot, cnorm


class GmresResult(NamedTuple):
    x: jax.Array
    relative_residual: jax.Array
    iterations: jax.Array


def _identity(r):
    return r


def fgmres(matvec: Callable, b: jax.Array, minv: Optional[Callable] = None,
           *, x0: Optional[jax.Array] = None, restart: int = 40,
           maxiter: int = 2000, tol: float = 1e-6,
           reorthogonalize: bool = True) -> GmresResult:
    """Solve A x = b with restarted right-preconditioned GMRES(restart)."""
    if minv is None:
        minv = _identity
    dtype = b.dtype
    m = restart
    bnorm = cnorm(b)
    x = jnp.zeros_like(b) if x0 is None else x0
    max_cycles = -(-maxiter // m)

    def cycle(state):
        x, _, it = state
        r = b - matvec(x)
        beta = cnorm(r)
        V = jnp.zeros((m + 1,) + b.shape, dtype)
        Z = jnp.zeros((m,) + b.shape, dtype)      # preconditioned basis M^{-1} v_j
        # Givens-updated QR of the Hessenberg: R (m x m), rhs g (m+1,)
        R = jnp.zeros((m, m), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta.astype(dtype))
        cs = jnp.zeros((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        V = V.at[0].set(r / jnp.where(beta == 0, 1.0, beta))

        def arnoldi(j, carry):
            V, Z, R, g, cs, sn = carry
            z = minv(V[j])
            w = matvec(z)

            def mgs(i, carry):
                w, h = carry
                hij = cdot(V[i], w)
                return w - hij * V[i], h.at[i].set(h[i] + hij.astype(dtype))

            h = jnp.zeros((m + 1,), dtype)
            w, h = jax.lax.fori_loop(0, j + 1, mgs, (w, h))
            if reorthogonalize:
                w, h = jax.lax.fori_loop(0, j + 1, mgs, (w, h))
            hn = cnorm(w)
            h = h.at[j + 1].set(hn.astype(dtype))
            V = V.at[j + 1].set(w / jnp.where(hn == 0, 1.0, hn))
            Z = Z.at[j].set(z)

            # apply the accumulated Givens rotations to the new column
            def rot(i, h):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hi1 = -jnp.conj(sn[i]) * h[i] + jnp.conj(cs[i]) * h[i + 1]
                return h.at[i].set(hi).at[i + 1].set(hi1)

            h = jax.lax.fori_loop(0, j, rot, h)
            # new rotation annihilating h[j+1]
            a, c = h[j], h[j + 1]
            denom = jnp.sqrt(jnp.abs(a) ** 2 + jnp.abs(c) ** 2)
            safe = jnp.where(denom == 0, 1.0, denom)
            cj = jnp.where(denom == 0, jnp.asarray(1.0, dtype), jnp.conj(a) / safe)
            sj = jnp.where(denom == 0, jnp.asarray(0.0, dtype), jnp.conj(c) / safe)
            h = h.at[j].set(cj * a + sj * c).at[j + 1].set(0.0)
            gj = g[j]
            g = g.at[j].set(cj * gj).at[j + 1].set(-jnp.conj(sj) * gj)
            R = R.at[:, j].set(h[:m])
            return V, Z, R, g, cs.at[j].set(cj), sn.at[j].set(sj)

        V, Z, R, g, cs, sn = jax.lax.fori_loop(0, m, arnoldi,
                                               (V, Z, R, g, cs, sn))

        # back-substitution R y = g[:m]
        def back(k, y):
            j = m - 1 - k
            num = g[j] - jnp.sum(R[j, :] * y) + R[j, j] * y[j]
            rjj = R[j, j]
            safe = jnp.where(jnp.abs(rjj) == 0, 1.0, rjj)
            return y.at[j].set(jnp.where(jnp.abs(rjj) == 0, 0.0, num / safe))

        y = jax.lax.fori_loop(0, m, back, jnp.zeros((m,), dtype))
        upd = (slice(None),) + (None,) * (Z.ndim - 1)
        x = x + jnp.sum(y[upd] * Z, axis=0)
        res = cnorm(b - matvec(x)) / bnorm
        return x, res, it + m

    def cond(state):
        _, res, it = state
        return jnp.logical_and(res > tol, it < max_cycles * m)

    r0 = cnorm(b - matvec(x)) / jnp.where(bnorm == 0, 1.0, bnorm)
    x, res, it = jax.lax.while_loop(cond, cycle, (x, r0, jnp.asarray(0)))
    return GmresResult(x=x, relative_residual=res, iterations=it)
