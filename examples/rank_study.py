"""Empirical rank study of the block-Thomas inverses W_r.

Question: can W_r (the stored (nc x nc) inverses whose memory sets the
direct solver's wall) be stored in rank-structured form? Measures, on the
bench's hard 1024^2 binary-5x scene, the numerical ranks of HODLR
off-diagonal blocks of W_r at several recursion depths and tolerances.
CPU, complex128 (exact reference arithmetic).
"""
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from fdtd2d.ops.helmholtz import make_operator
from fdtd2d.fdfd.direct import five_point_coefficients

N, omega, dx = 1024, 17e9, 1e-3
from fdtd2d.core.scenes import hard_binary_scene  # noqa: E402
eps, mu, _ = hard_binary_scene(N, seed=7)

op = make_operator(eps, mu, dx, dx, omega, pml_thickness=40,
                   dtype=jnp.complex128)
d, e, w, s, n = (np.asarray(a) for a in five_point_coefficients(op))

# sublattice (0, 0)
px, py = 0, 0
sub = lambda a: a[px::2, py::2]
ds, es, ws, ns, ss = sub(d), sub(e), sub(w), sub(n), sub(s)
nr, nc = ds.shape
print(f"sublattice rows={nr} cols={nc}")


def tridiag(dr, er, wr):
    A = np.diag(dr) + np.diag(er[:-1], 1) + np.diag(wr[1:], -1)
    return A


def block_ranks(W, tols=(1e-2, 1e-3, 1e-4)):
    """HODLR level-1..3 off-diagonal block ranks (relative to ||W||_2 of the
    block itself and to the global scale)."""
    out = {}
    gs = np.linalg.norm(W, 2)
    for lev in (1, 2, 3):
        nb = nc >> lev
        ranks_rel, ranks_glob = {t: [] for t in tols}, {t: [] for t in tols}
        for bi in range(1 << lev):
            for bj in range(1 << lev):
                if abs(bi - bj) != 1:
                    continue
                B = W[bi * nb:(bi + 1) * nb, bj * nb:(bj + 1) * nb]
                sv = np.linalg.svd(B, compute_uv=False)
                for t in tols:
                    ranks_rel[t].append(int(np.sum(sv > t * sv[0])))
                    ranks_glob[t].append(int(np.sum(sv > t * gs)))
        out[lev] = {t: (max(ranks_rel[t]), max(ranks_glob[t])) for t in tols}
    return out


W = np.linalg.inv(tridiag(ds[0], es[0], ws[0]))
sample_at = {1, 2, 4, 8, 16, 32, 64, 128, 256, 511}
for r in range(1, nr):
    A = tridiag(ds[r], es[r], ws[r])
    U = A - ns[r][:, None] * W * ss[r - 1][None, :]
    W = np.linalg.inv(U)
    if r in sample_at:
        br = block_ranks(W)
        print(f"r={r:4d}  |W|max={np.abs(W).max():.2e}")
        for lev, tolmap in br.items():
            parts = ", ".join(f"tol{t:g}: rel={a} glob={g}"
                              for t, (a, g) in tolmap.items())
            print(f"   lev{lev} (nb={nc >> lev}): {parts}")

# also: how well does a pure banded-plus-global-low-rank model do at r=511?
for k in (8, 16, 32, 64):
    u, sv, vt = np.linalg.svd(W)
    Wk = (u[:, :k] * sv[:k]) @ vt[:k]
    print(f"global rank {k}: rel err {np.linalg.norm(W - Wk) / np.linalg.norm(W):.3e}")
