"""HPS-style nested-dissection direct solve: dense batched fronts, O(N^2 log N)
memory, log-depth batched solves.

This is the second exact factorization of the outrigger operator (the first
is the sublattice block-Thomas in fdtd2d/fdfd/direct.py, whose stored
inverses cost 4*(N/2)^3*8 B — the memory wall past ~1024^2). It implements
the reference's direct-solve intent (scipy spsolve at
python-src/fdfd.py:112 is itself a sparse multifrontal factorization; the
Eigen SparseLU skeleton in src/fdfd.cpp:1-16 was never written) in the form
accelerator literature recommends for this hardware class: a Hierarchical
Poincare-Steklov / nested-dissection factorization whose fronts are DENSE
blocks batched level-by-level (see PAPERS.md, "Hardware Acceleration for
HPS Algorithms in Two and Three Dimensions", arXiv:2503.17535) — every
factor and solve step is a vmapped dense inverse/matmul.

Structure. Each of the four decoupled (i mod 2, j mod 2) sublattices (see
fdfd/direct.py module docstring) carries a standard 5-point complex
Helmholtz system on an (nr, nc) grid. The grid is tiled by m x m leaf
boxes; boxes merge pairwise up a binary tree, alternating axes. A box's
ACTIVE points are its outer layer (the only points a 5-point stencil
couples to the outside); merging two boxes eliminates the two interface
layers that become interior. With J the eliminated points and R the kept
(parent-ring) points of a merge,

    Y = A_JJ^{-1},   E = Y A_JR,   S_parent = A_RR - A_JR^T E,

where A is assembled from the children's Schur complements S_1, S_2 plus
the original interface couplings. The operator is complex SYMMETRIC
(A = C^T M C - omega^2 M_eps with diagonal Ms; verified to f32 rounding in
tests), and the assembly here uses one coefficient per edge, so all Schur
complements stay exactly symmetric and only (Y, E) are stored per node:
A_RJ x = E^T (A_JJ x) collapses to E^T b_J in the upward pass. Per merge
level the persistent storage is ~64 N^2 bytes — O(N^2 log N) total versus
the O(N^3) stored-inverse wall — and a solve is two sweeps of ~log2(N/m)
batched dense matmuls instead of N sequential scan steps.

Like every c64 factorization in this package, the solve is wrapped in
split-complex f64 iterative refinement (fdfd/refine.py) by
``DirectSolver(hps=True)``; the symmetrized assembly differs from the true
operator by ~1e-7 relative (f32 rounding), which refinement absorbs the
same way it absorbs the factorization's own rounding.

Measured accuracy boundary (hard 50%-duty binary 5x scene, 17 GHz,
m=8). The factorization is EXACT in c128 (rel res 9e-14 at 256^2, 8e-13
at 512^2, CPU) but its raw c64 error grows ~10x per grid doubling
(5e-5 at 256^2, 5e-4 at 512^2): the interface Schur systems of the
indefinite Helmholtz operator are near-resonant (zero-Dirichlet boxes —
same mechanism as the Schwarz-patch resonance noted in fdfd/tiled.py),
so each of the ~2 log2(N/2m) merge levels amplifies f32 rounding.
Refinement recovers full accuracy THROUGH 1024^2 (measured: 1.6e-9
in 3 rounds at 256^2, 3.2e-11 in 4 at 512^2, 8.5e-9 in 21 rounds at
1024^2 — contraction ~0.5/round there, whence
DirectSolver's mode-aware max_refine_rounds default of 40); at 2048^2
the raw c64 error reaches O(10) and refinement cannot contract — use
the HODLR-compressed or checkpointed block-Thomas modes there
(fdfd/direct.py, fdfd/compressed.py). Diagonal equilibration does not
help (measured 1.2e-3 vs 5.2e-4 at 512^2); an f64 factor path would
trade the f32 tensor-core rate for f64 (its speed on this card: not
measured). Within its boundary the mode's value is MEMORY: the
smallest exact-factor store of any mode (3.2x smaller than stored-W at
1024^2, 1.36 vs 4.3 GB) with log-depth batched solves.

All index bookkeeping is precomputed in numpy (:func:`build_plan`) as
STATIC per-level gather/scatter maps — boxes at a level are congruent, so
one plan serves every box and the whole factorization compiles to a fixed
sequence of batched dense ops (no data-dependent control flow).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fdtd2d.ops.helmholtz import HelmholtzOperator
from fdtd2d.fdfd.direct import five_point_coefficients, _PARITIES


# ---------------------------------------------------------------------------
# Plans (pure numpy, cached per geometry)
# ---------------------------------------------------------------------------


def _ring_pts(p: int, q: int) -> List[Tuple[int, int]]:
    """Outer-layer coords of a p x q box, row-major (the canonical skeleton
    ordering used everywhere in this module)."""
    return [(r, c) for r in range(p) for c in range(q)
            if r in (0, p - 1) or c in (0, q - 1)]


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    m: int
    n_boxes: int
    origins: np.ndarray      # (n_boxes, 2) box origin in sublattice coords
    idx_I: np.ndarray        # interior positions within the m^2 row-major box
    idx_R: np.ndarray        # ring positions (canonical order)
    ent_r: np.ndarray        # dense-assembly rows (within m^2 x m^2)
    ent_c: np.ndarray        # dense-assembly cols
    ent_src: np.ndarray      # 0=d, 1=col-edge (E_col), 2=row-edge (E_row)
    ent_loc: np.ndarray      # local flat index of the coefficient to gather


@dataclasses.dataclass(frozen=True)
class MergePlan:
    axis: int                   # 1: children side-by-side in columns
    child_shape: Tuple[int, int]
    parent_shape: Tuple[int, int]
    n_parents: int
    pair1: np.ndarray           # (n_parents,) indices into the child batch
    pair2: np.ndarray
    origins: np.ndarray         # (n_parents, 2) parent box origins
    idx_J: np.ndarray           # positions in the concatenated child skeleton
    idx_R: np.ndarray           # ... ordered to the parent's canonical ring
    coup_a: np.ndarray          # interface pairs: position of the first point
    coup_b: np.ndarray          # ... of the second (in the concatenated skel)
    coup_loc: np.ndarray        # parent-local flat coord of the edge value
    J_coords: np.ndarray        # (nJ, 2) parent-local coords of J points


@dataclasses.dataclass(frozen=True)
class HPSPlan:
    nr: int
    nc: int
    leaf: LeafPlan
    merges: Tuple[MergePlan, ...]
    root_coords: np.ndarray     # (rho_root, 2) coords of the root skeleton


@functools.lru_cache(maxsize=8)
def build_plan(nr: int, nc: int, m: int = 8) -> HPSPlan:
    """Nested-dissection plan for an (nr, nc) 5-point grid with m x m
    leaves. Requires nr, nc divisible by m with power-of-two box counts."""
    if nr % m or nc % m:
        raise ValueError(f"grid ({nr},{nc}) not divisible by leaf {m}")
    Br, Bc = nr // m, nc // m
    if Br & (Br - 1) or Bc & (Bc - 1):
        raise ValueError(f"box grid ({Br},{Bc}) must be powers of two")

    # --- leaf plan ---
    pts = [(r, c) for r in range(m) for c in range(m)]
    ring = set(_ring_pts(m, m))
    idx_I = np.array([k for k, pt in enumerate(pts) if pt not in ring],
                     np.int32)
    idx_R = np.array([k for k, pt in enumerate(pts) if pt in ring], np.int32)
    er, ec, esrc, eloc = [], [], [], []
    for k, (r, c) in enumerate(pts):
        er.append(k); ec.append(k); esrc.append(0); eloc.append(k)
        if c < m - 1:   # edge (r,c)-(r,c+1), value E_col at (r,c)
            for a, b in ((k, k + 1), (k + 1, k)):
                er.append(a); ec.append(b); esrc.append(1); eloc.append(k)
        if r < m - 1:   # edge (r,c)-(r+1,c), value E_row at (r,c)
            for a, b in ((k, k + m), (k + m, k)):
                er.append(a); ec.append(b); esrc.append(2); eloc.append(k)
    origins = np.array([(br * m, bc * m) for br in range(Br)
                        for bc in range(Bc)], np.int32)
    leaf = LeafPlan(m=m, n_boxes=Br * Bc, origins=origins,
                    idx_I=idx_I, idx_R=idx_R,
                    ent_r=np.array(er, np.int32), ent_c=np.array(ec, np.int32),
                    ent_src=np.array(esrc, np.int32),
                    ent_loc=np.array(eloc, np.int32))

    # --- merge levels ---
    merges = []
    cur_pts = [pts[k] for k in idx_R]        # skeleton coords, canonical order
    shape = (m, m)
    while Br * Bc > 1:
        axis = 1 if Bc >= Br else 0          # alternates for square domains
        p, q = shape
        if axis == 1:
            parent_shape, off2 = (p, 2 * q), (0, q)
            nBr, nBc = Br, Bc // 2
            pair1 = np.array([r * Bc + 2 * c for r in range(nBr)
                              for c in range(nBc)], np.int32)
        else:
            parent_shape, off2 = (2 * p, q), (p, 0)
            nBr, nBc = Br // 2, Bc
            pair1 = np.array([2 * r * Bc + c for r in range(nBr)
                              for c in range(nBc)], np.int32)
        pair2 = pair1 + (1 if axis == 1 else Bc)
        allpts = cur_pts + [(r + off2[0], c + off2[1]) for r, c in cur_pts]
        pos = {pt: i for i, pt in enumerate(allpts)}
        pring = set(_ring_pts(*parent_shape))
        J = sorted((pt for pt in allpts if pt not in pring))
        parent_pts = _ring_pts(*parent_shape)
        assert sorted(allpts) == sorted(J + parent_pts)
        idxJ = np.array([pos[pt] for pt in J], np.int32)
        idxR = np.array([pos[pt] for pt in parent_pts], np.int32)
        if axis == 1:
            ca = [pos[(r, q - 1)] for r in range(p)]
            cb = [pos[(r, q)] for r in range(p)]
            cloc = [r * parent_shape[1] + (q - 1) for r in range(p)]
        else:
            ca = [pos[(p - 1, c)] for c in range(q)]
            cb = [pos[(p, c)] for c in range(q)]
            cloc = [(p - 1) * parent_shape[1] + c for c in range(q)]
        porig = (origins[pair1]).astype(np.int32)
        merges.append(MergePlan(
            axis=axis, child_shape=shape, parent_shape=parent_shape,
            n_parents=nBr * nBc, pair1=pair1, pair2=pair2, origins=porig,
            idx_J=idxJ, idx_R=idxR,
            coup_a=np.array(ca, np.int32), coup_b=np.array(cb, np.int32),
            coup_loc=np.array(cloc, np.int32),
            J_coords=np.array(J, np.int32)))
        cur_pts, shape, Br, Bc, origins = parent_pts, parent_shape, nBr, nBc, porig

    return HPSPlan(nr=nr, nc=nc, leaf=leaf, merges=tuple(merges),
                   root_coords=np.array(cur_pts, np.int32))


# ---------------------------------------------------------------------------
# Factorization (JAX; all dense ops batched over boxes)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LevelFactors:
    Y: jax.Array    # (n_parents, nJ, nJ) = A_JJ^{-1}
    E: jax.Array    # (n_parents, nJ, nR) = Y @ A_JR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SubHPSFactors:
    leaf: LevelFactors          # leaf interior elimination (nI, rho)
    levels: Tuple[LevelFactors, ...]
    Yroot: jax.Array            # (rho_root, rho_root)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HPSFactors:
    subs: Tuple[SubHPSFactors, SubHPSFactors, SubHPSFactors, SubHPSFactors]
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))


def _cinv(A):
    # batched LU-with-partial-pivoting inverse; HIGHEST matmul precision —
    # a default f32 matmul may run in TF32 on a GPU, which the direct
    # recursion cannot spare
    with jax.default_matmul_precision("highest"):
        return jnp.linalg.inv(A)


def _ein(spec, a, b):
    # HIGHEST: a float32 contraction may otherwise run in TF32 on a GPU
    return jnp.einsum(spec, a, b, precision=jax.lax.Precision.HIGHEST)


def _mm(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _gidx(origins, local_flat, ncols, shape):
    """Global flat indices: box origins (B, 2) + local flat offsets (k,)
    within a box of ``shape`` -> (B, k) int32."""
    lr, lc = local_flat // shape[1], local_flat % shape[1]
    return ((origins[:, 0:1] + lr[None, :]) * ncols
            + (origins[:, 1:2] + lc[None, :]))


def _onehot(idx: np.ndarray, width: int) -> np.ndarray:
    """(k, width) float32 one-hot rows for static scatter-as-matmul."""
    P = np.zeros((len(idx), width), np.float32)
    P[np.arange(len(idx)), idx] = 1.0
    return P


def hps_factor_sub(d, Ecol, Erow, plan: HPSPlan) -> SubHPSFactors:
    """Factor one sublattice 5-point system. d/Ecol/Erow: (nr, nc) complex
    coefficient arrays (diagonal; column-edge; row-edge values)."""
    nc_g = plan.nc
    lf = plan.leaf
    m = lf.m

    srcs = (d.ravel(), Ecol.ravel(), Erow.ravel())
    gi = _gidx(jnp.asarray(lf.origins), jnp.asarray(lf.ent_loc), nc_g, (m, m))
    vals = jnp.where(lf.ent_src[None, :] == 0, srcs[0][gi],
                     jnp.where(lf.ent_src[None, :] == 1, srcs[1][gi],
                               srcs[2][gi]))
    # scatter-as-matmul: the entry positions are static and unique, so
    # assembly is one exact one-hot matmul instead of a batched scatter-add
    # over 10k+ boxes (HIGHEST precision keeps the products with 1.0 exact)
    P_leaf = jnp.asarray(_onehot(lf.ent_r * (m * m) + lf.ent_c, m ** 4),
                         d.dtype)
    A = _mm(vals, P_leaf).reshape(lf.n_boxes, m * m, m * m)
    iI, iR = lf.idx_I, lf.idx_R
    A_II = A[:, iI[:, None], iI[None, :]]
    A_IR = A[:, iI[:, None], iR[None, :]]
    A_RR = A[:, iR[:, None], iR[None, :]]
    Y = _cinv(A_II)
    E = _mm(Y, A_IR)
    S = A_RR - _mm(jnp.swapaxes(A_IR, 1, 2), E)
    leaf = LevelFactors(Y=Y, E=E)

    levels = []
    for mp in plan.merges:
        rho = S.shape[1]
        S1, S2 = S[mp.pair1], S[mp.pair2]
        cv = Ecol.ravel() if mp.axis == 1 else Erow.ravel()
        cvals = cv[_gidx(jnp.asarray(mp.origins), jnp.asarray(mp.coup_loc),
                         nc_g, mp.parent_shape)]
        Acat = jnp.zeros((mp.n_parents, 2 * rho, 2 * rho), d.dtype)
        Acat = Acat.at[:, :rho, :rho].set(S1).at[:, rho:, rho:].set(S2)
        # interface couplings live entirely in the child1-ring x child2-ring
        # off-diagonal block (coup_a < rho <= coup_b by construction):
        # C = A1^T diag(cvals) A2 with static one-hot A1/A2 — a batched
        # matmul plus two contiguous block adds, no scatter (see leaf note)
        A1 = jnp.asarray(_onehot(mp.coup_a, rho), d.dtype)
        A2 = jnp.asarray(_onehot(mp.coup_b - rho, rho), d.dtype)
        C = _mm(jnp.swapaxes(A1, 0, 1)[None, :, :],
                cvals[:, :, None] * A2[None, :, :])
        Acat = Acat.at[:, :rho, rho:].add(C)
        Acat = Acat.at[:, rho:, :rho].add(jnp.swapaxes(C, 1, 2))
        iJ, iR = mp.idx_J, mp.idx_R
        A_JJ = Acat[:, iJ[:, None], iJ[None, :]]
        A_JR = Acat[:, iJ[:, None], iR[None, :]]
        A_RR = Acat[:, iR[:, None], iR[None, :]]
        Y = _cinv(A_JJ)
        E = _mm(Y, A_JR)
        S = A_RR - _mm(jnp.swapaxes(A_JR, 1, 2), E)
        levels.append(LevelFactors(Y=Y, E=E))

    Yroot = _cinv(S[0])
    return SubHPSFactors(leaf=leaf, levels=tuple(levels), Yroot=Yroot)


def hps_solve_sub(f: SubHPSFactors, plan: HPSPlan, b):
    """x = A^{-1} b on one factored sublattice; b (nr, nc) -> x (nr, nc).
    Upward sweep folds the RHS to the root; downward sweep back-substitutes.
    Every step is one batched dense matmul."""
    nc_g = plan.nc
    lf = plan.leaf
    m = lf.m
    bf = b.ravel()

    box_flat = np.arange(m * m, dtype=np.int32)
    gb = _gidx(jnp.asarray(lf.origins), jnp.asarray(box_flat), nc_g, (m, m))
    b_box = bf[gb]                                    # (n_boxes, m^2)
    b_I = b_box[:, lf.idx_I]
    g_leaf = _ein("bij,bj->bi", f.leaf.Y, b_I)
    bs = b_box[:, lf.idx_R] - _ein("bji,bj->bi", f.leaf.E, b_I)

    gs = []
    for mp, lev in zip(plan.merges, f.levels):
        bcat = jnp.concatenate([bs[mp.pair1], bs[mp.pair2]], axis=1)
        b_J = bcat[:, mp.idx_J]
        g = _ein("bij,bj->bi", lev.Y, b_J)
        gs.append(g)
        bs = bcat[:, mp.idx_R] - _ein("bji,bj->bi", lev.E, b_J)

    x = jnp.zeros_like(bf)
    x_R = _mm(f.Yroot, bs[0])                         # (rho_root,)
    root_g = (plan.root_coords[:, 0].astype(np.int32) * nc_g
              + plan.root_coords[:, 1])
    x = x.at[jnp.asarray(root_g)].set(x_R)
    xs = x_R[None, :]                                 # (1, rho_root)

    for mp, lev, g in zip(plan.merges[::-1], f.levels[::-1], gs[::-1]):
        x_J = g - _ein("bij,bj->bi", lev.E, xs)
        gj = _gidx(jnp.asarray(mp.origins),
                   jnp.asarray(mp.J_coords[:, 0] * mp.parent_shape[1]
                               + mp.J_coords[:, 1]), nc_g, mp.parent_shape)
        x = x.at[gj.ravel()].set(x_J.ravel())
        rho = (x_J.shape[1] + xs.shape[1]) // 2       # child skeleton size
        xcat = jnp.zeros((xs.shape[0], x_J.shape[1] + xs.shape[1]), x.dtype)
        xcat = xcat.at[:, mp.idx_J].set(x_J).at[:, mp.idx_R].set(xs)
        nchild = 2 * xs.shape[0]
        child_xs = jnp.zeros((nchild, rho), x.dtype)
        child_xs = child_xs.at[jnp.asarray(mp.pair1)].set(xcat[:, :rho])
        child_xs = child_xs.at[jnp.asarray(mp.pair2)].set(xcat[:, rho:])
        xs = child_xs

    x_I = g_leaf - _ein("bij,bj->bi", f.leaf.E, xs)
    gI = _gidx(jnp.asarray(lf.origins), jnp.asarray(lf.idx_I), nc_g, (m, m))
    x = x.at[gI.ravel()].set(x_I.ravel())
    return x.reshape(plan.nr, plan.nc)


@functools.partial(jax.jit, static_argnames=("m",))
def hps_factor(op: HelmholtzOperator, m: int = 8) -> HPSFactors:
    """Factor the full outrigger operator: four sublattice HPS trees."""
    d, e, w, s, n = five_point_coefficients(op)
    del w, n  # symmetric partners of e/s (equal to f32 rounding)
    subs = []
    for (px, py) in _PARITIES:
        ds, es, ss = d[px::2, py::2], e[px::2, py::2], s[px::2, py::2]
        plan = build_plan(ds.shape[0], ds.shape[1], m)
        subs.append(hps_factor_sub(ds, es, ss, plan))
    return HPSFactors(subs=tuple(subs), shape=op.shape, m=m)


def factor_bytes(f: HPSFactors) -> int:
    """Total bytes of stored factors (the O(N^2 log N) footprint)."""
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(f))


def predicted_factor_bytes(N: int, m: int = 8, itemsize: int = 8) -> int:
    """Exact stored-factor size for an N x N outrigger grid (4 sublattices
    of side N//2), computed from the plan alone — no factorization.

    Measured against the stored-W wall 4*(N/2)^3*8 B the crossover sits at
    N≈256 (ratio 1.05 at m=8); the win grows as N/log N: ~3.2x at 1024²,
    ~5.6x at 2048² (6.1 GB — the smallest stored-factor mode at this
    size), ~10x at 4096², ~18x at 8192².
    """
    s = N // 2
    plan = build_plan(s, s, m)
    lf = plan.leaf
    tot = lf.n_boxes * (len(lf.idx_I) ** 2 + len(lf.idx_I) * len(lf.idx_R))
    for mp in plan.merges:
        tot += mp.n_parents * (len(mp.idx_J) ** 2
                               + len(mp.idx_J) * len(mp.idx_R))
    tot += len(plan.root_coords) ** 2
    return 4 * tot * itemsize


@jax.jit
def hps_solve(f: HPSFactors, b) -> jax.Array:
    """x = A^{-1} b from prebuilt HPS factors; b (Nx, Ny) complex."""
    Nx, Ny = f.shape
    b = b.reshape(Nx, Ny)
    x = jnp.zeros_like(b)
    for (px, py), fs in zip(_PARITIES, f.subs):
        bsub = b[px::2, py::2]
        plan = build_plan(bsub.shape[0], bsub.shape[1], f.m)
        x = x.at[px::2, py::2].set(hps_solve_sub(fs, plan, bsub))
    return x
