"""Exact Helmholtz solve: sublattice block-Thomas factorization.

This is the direct sparse solver the reference intended to build in C++
(Eigen SparseLU includes in src/fdfd.cpp:1-3, never written) and actually
uses from scipy (spsolve, python-src/fdfd.py:112), reborn as dense
linear algebra on the accelerator:

The "outrigger" operator couples only flat offsets {+-2, +-2N}
(SURVEY.md section 2, C2): point (i, j) talks to (i+-2, j) and (i, j+-2).
Points therefore split by (i mod 2, j mod 2) into FOUR independent
half-resolution sublattices, each carrying a standard 5-point complex
Helmholtz system. On each sublattice the matrix is block-tridiagonal over
sublattice rows with

    - tridiagonal diagonal blocks  (within-row j+-2 coupling), and
    - DIAGONAL off-diagonal blocks (row i+-2 coupling — same column only),

so the block-Thomas (block-LU) recursion

    U_0 = A_0,   U_r = A_r - diag(n_r) U_{r-1}^{-1} diag(s_{r-1})

costs one dense (nc x nc) inverse per block row and NO matmuls (the
diagonal off-blocks reduce the triple product to elementwise row/column
scaling of the stored inverse W_{r-1}). Solves against the stored inverses
are two matvecs per block row (a forward and a backward scan) — repeat
solves on a factored scene run in milliseconds, batched solves (vmap over
scenes) turn the matvecs into matmuls.

Unlike every Krylov/Schwarz option in fdtd2d/fdfd/solver.py and
tiled.py, the cost here is INDEPENDENT of material contrast: genuinely hard
scenes (50% duty binary 5x media at ~lambda/8 resolution — the surrogate
datagen distribution, where two-level ORAS stalls at ~0.3 relative
residual) factor and solve exactly. complex64 block-LU without pivoting
loses a few digits; :class:`DirectSolver` wraps the solve in split-complex
f64 iterative refinement (fdtd2d/fdfd/refine.py), which restores true
f64 residuals at ~one extra solve per decade of accuracy.

Coefficient derivation (validated against HelmholtzOperator.apply in
tests/test_direct.py): expanding the two zero-truncated central
differences in ops/helmholtz.py:100-108,

    A x(i,j) =  d(i,j) x(i,j) + e(i,j) x(i,j+2) + w(i,j) x(i,j-2)
              + s(i,j) x(i+2,j) + n(i,j) x(i-2,j)
    e(i,j) = -a_c^2 isc(j) isc(j+2) im(i,j+1)      (j <= Ny-3)
    w(i,j) = -a_c^2 isc(j) isc(j-2) im(i,j-1)      (j >= 2)
    s(i,j) = -a_r^2 isr(i) isr(i+2) im(i+1,j)      (i <= Nx-3)
    n(i,j) = -a_r^2 isr(i) isr(i-2) im(i-1,j)      (i >= 2)
    d(i,j) = HelmholtzOperator.diagonal()
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from fdtd2d.ops.helmholtz import HelmholtzOperator


def five_point_coefficients(op: HelmholtzOperator):
    """(d, e, w, s, n) coefficient arrays, each (Nx, Ny) complex; entries at
    invalid offsets (within 2 of the relevant edge) are zero."""
    Nx, Ny = op.shape
    ac2 = op.inv_2dx**2
    ar2 = op.inv_2dy**2
    im = op.inv_mu
    isc = op.inv_s_col
    isr = op.inv_s_row

    zc = jnp.zeros((Nx, 2), im.dtype)
    zr = jnp.zeros((2, Ny), im.dtype)
    # im shifted by one toward the coupled neighbor, zero at the edges
    im_cp = jnp.concatenate([im[:, 1:-1], zc], axis=1)    # im(i, j+1), j<=Ny-3
    im_cm = jnp.concatenate([zc, im[:, 1:-1]], axis=1)    # im(i, j-1), j>=2
    im_rp = jnp.concatenate([im[1:-1, :], zr], axis=0)
    im_rm = jnp.concatenate([zr, im[1:-1, :]], axis=0)

    csz = jnp.zeros((2,), isc.dtype)
    rsz = jnp.zeros((2,), isr.dtype)
    isc_p = jnp.concatenate([isc[2:], csz])               # isc(j+2)
    isc_m = jnp.concatenate([csz, isc[:-2]])              # isc(j-2)
    isr_p = jnp.concatenate([isr[2:], rsz])
    isr_m = jnp.concatenate([rsz, isr[:-2]])

    e = -ac2 * (isc * isc_p)[None, :] * im_cp
    w = -ac2 * (isc * isc_m)[None, :] * im_cm
    s = -ar2 * (isr * isr_p)[:, None] * im_rp
    n = -ar2 * (isr * isr_m)[:, None] * im_rm
    return op.diagonal(), e, w, s, n


def _tridiag(d_row, e_row, w_row):
    """Dense (nc, nc) tridiagonal block from coefficient rows: row c holds
    w(c) at c-1, d(c) at c, e(c) at c+1."""
    nc = d_row.shape[0]
    I0 = jnp.eye(nc, dtype=d_row.dtype)
    Ip = jnp.eye(nc, k=1, dtype=d_row.dtype)
    Im = jnp.eye(nc, k=-1, dtype=d_row.dtype)
    return I0 * d_row[:, None] + Ip * e_row[:, None] + Im * w_row[:, None]


def _cinv(A):
    # HIGHEST matmul precision inside the inverse: a default f32 matmul may
    # run in TF32 on a GPU, which costs digits the no-pivoting recursion
    # cannot spare
    with jax.default_matmul_precision("highest"):
        return jnp.linalg.inv(A)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SublatticeFactors:
    Ws: jax.Array      # (nr, nc, nc) stored block inverses U_r^{-1}
    nvals: jax.Array   # (nr, nc) coupling to row r-1 (row 0 unused)
    svals: jax.Array   # (nr, nc) coupling to row r+1 (last row unused)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DirectFactors:
    """Factors for the four (i mod 2, j mod 2) sublattices, in the fixed
    order (0,0), (0,1), (1,0), (1,1)."""
    subs: Tuple[SublatticeFactors, SublatticeFactors,
                SublatticeFactors, SublatticeFactors]
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))


_PARITIES = ((0, 0), (0, 1), (1, 0), (1, 1))


def _factor_sub(d, e, w, nvals, svals) -> SublatticeFactors:
    """Block-Thomas factorization of one sublattice ((nr, nc) coefficient
    arrays). The diagonal off-blocks make the Schur update matmul-free."""
    W0 = _cinv(_tridiag(d[0], e[0], w[0]))

    def body(Wprev, row):
        d_r, e_r, w_r, n_r, s_rm1 = row
        A = _tridiag(d_r, e_r, w_r)
        U = A - n_r[:, None] * Wprev * s_rm1[None, :]
        W = _cinv(U)
        return W, W

    _, Ws = jax.lax.scan(body, W0, (d[1:], e[1:], w[1:], nvals[1:],
                                    svals[:-1]))
    return SublatticeFactors(
        Ws=jnp.concatenate([W0[None], Ws], axis=0), nvals=nvals, svals=svals)


def _solve_sub(f: SublatticeFactors, b):
    """x = A^{-1} b on one factored sublattice; b (nr, nc). Two scans of one
    (nc x nc) matvec each."""
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    z0 = mm(f.Ws[0], b[0])

    def fwd(zprev, row):
        b_r, n_r, W_r = row
        z_r = mm(W_r, b_r - n_r * zprev)
        return z_r, z_r

    _, zs = jax.lax.scan(fwd, z0, (b[1:], f.nvals[1:], f.Ws[1:]))
    zs = jnp.concatenate([z0[None], zs], axis=0)

    x_last = zs[-1]

    def bwd(xnext, row):
        z_r, W_r, s_r = row
        x_r = z_r - mm(W_r, s_r * xnext)
        return x_r, x_r

    _, xs = jax.lax.scan(bwd, x_last,
                         (zs[:-1], f.Ws[:-1], f.svals[:-1]), reverse=True)
    return jnp.concatenate([xs, x_last[None]], axis=0)


@jax.jit
def factor(op: HelmholtzOperator) -> DirectFactors:
    """Factor A into the four sublattice block-Thomas forms (build once,
    solve many; vmap over a batch of operators for datagen)."""
    d, e, w, s, n = five_point_coefficients(op)
    subs = []
    for (px, py) in _PARITIES:
        sub = lambda a: a[px::2, py::2]
        subs.append(_factor_sub(sub(d), sub(e), sub(w), sub(n), sub(s)))
    return DirectFactors(subs=tuple(subs), shape=op.shape)


@jax.jit
def solve_factored(f: DirectFactors, b) -> jax.Array:
    """x = A^{-1} b from prebuilt factors; b (Nx, Ny) complex."""
    Nx, Ny = f.shape
    b = b.reshape(Nx, Ny)
    x = jnp.zeros_like(b)
    for (px, py), fs in zip(_PARITIES, f.subs):
        x = x.at[px::2, py::2].set(_solve_sub(fs, b[px::2, py::2]))
    return x


def solve_direct(op: HelmholtzOperator, b) -> jax.Array:
    """One-shot exact solve (factor + solve)."""
    return solve_factored(factor(op), b)


# ---------------------------------------------------------------------------
# Stacked variants: all four sublattices as ONE batched scan
# ---------------------------------------------------------------------------
#
# For even Nx/Ny the four sublattices have identical (N/2, N/2) shapes, so
# their factor/solve scans stack on a leading length-4 axis: jax.vmap turns
# the four SEQUENTIAL per-sublattice scans into one scan whose body does 4x
# the (tiny, latency-bound) matmul work per step. The warm solve is dominated
# by sequential scan-step latency, not FLOPs, so this is a ~4x wall-clock
# lever on one device — and the same stacked axis is what
# parallel/direct_sharded.py distributes over a device mesh.


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StackedFactors:
    """The four sublattice factor sets stacked on a leading axis (even N).
    ``stacked`` may hold Sublattice/CkptSublattice/CompressedSublattice
    factors — :func:`solve_stacked` dispatches on the type."""
    stacked: object                     # leaves have leading axis 4
    shape: tuple = dataclasses.field(metadata=dict(static=True))


@jax.jit
def stack_coefficients(op: HelmholtzOperator):
    """Five-point coefficients restricted to each sublattice and stacked on
    a leading length-4 axis, order (d, e, w, n, s) matching the per-
    sublattice factor signatures."""
    d, e, w, s, n = five_point_coefficients(op)

    def subs(a):
        return jnp.stack([a[px::2, py::2] for (px, py) in _PARITIES])

    return subs(d), subs(e), subs(w), subs(n), subs(s)


# Split-complex storage for the stacked paths: factors are stored as f32
# (re, im) pairs, so that a program consuming a big store as a scan input
# needs no split copy of it as a temporary (same total bytes), and scanning
# the FULL row
# arrays (valid because the edge-zeroed coefficients make nvals[0] == 0 and
# svals[-1] == 0 on every sublattice) removes the a[1:]/a[:-1] slice copies
# the old scans paid per solve.


def _split(a):
    return jnp.real(a), jnp.imag(a)


def _cmm(Ar, Ai, vr, vi):
    """Split-complex matmul (Ar + i Ai) @ (vr + i vi) at HIGHEST precision
    — the same four real matmuls a native complex matmul lowers to."""
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return mm(Ar, vr) - mm(Ai, vi), mm(Ar, vi) + mm(Ai, vr)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SplitSublatticeFactors:
    """Stored block inverses in split-complex form (see note above)."""
    Wre: jax.Array     # (nr, nc, nc) real part of U_r^{-1}
    Wim: jax.Array     # (nr, nc, nc) imaginary part
    nvals: jax.Array   # (nr, nc) complex coupling to row r-1 (row 0 zero)
    svals: jax.Array   # (nr, nc) complex coupling to row r+1 (last row zero)


def _factor_sub_split(d, e, w, nvals, svals) -> SplitSublatticeFactors:
    """Block-Thomas factorization emitting split-stored inverses via ONE
    full-row scan: nvals[0] == 0 zeroes the Schur update at row 0, so the
    first row needs no special case (svals rolls by one to align s_{r-1})."""
    nc = d.shape[1]
    W0 = jnp.zeros((nc, nc), d.dtype)

    def body(Wprev, row):
        d_r, e_r, w_r, n_r, s_rm1 = row
        U = _tridiag(d_r, e_r, w_r) - n_r[:, None] * Wprev * s_rm1[None, :]
        W = _cinv(U)
        return W, _split(W)

    _, (Wre, Wim) = jax.lax.scan(
        body, W0, (d, e, w, nvals, jnp.roll(svals, 1, axis=0)))
    return SplitSublatticeFactors(Wre=Wre, Wim=Wim, nvals=nvals, svals=svals)


def _solve_sub_split(f: SplitSublatticeFactors, b):
    """x = A^{-1} b on one split-stored sublattice; b (nr, nc) complex.
    Both scans run over the full row arrays (no slice copies): the zero
    first-row nvals / last-row svals make the extra terms vanish."""
    br, bi = _split(b)
    nre, nim = _split(f.nvals)
    sre, sim = _split(f.svals)
    nc = br.shape[1]
    z0 = (jnp.zeros(nc, br.dtype), jnp.zeros(nc, br.dtype))

    def fwd(z, xs):
        zr, zi = z
        b_r, b_i, n_r, n_i, Wr, Wi = xs
        yr = b_r - (n_r * zr - n_i * zi)
        yi = b_i - (n_r * zi + n_i * zr)
        z = _cmm(Wr, Wi, yr, yi)
        return z, z

    _, (zr, zi) = jax.lax.scan(fwd, z0, (br, bi, nre, nim, f.Wre, f.Wim))

    def bwd(x, xs):
        xr, xi = x
        z_r, z_i, s_r, s_i, Wr, Wi = xs
        tr = s_r * xr - s_i * xi
        ti = s_r * xi + s_i * xr
        cr, ci = _cmm(Wr, Wi, tr, ti)
        x = (z_r - cr, z_i - ci)
        return x, x

    _, (xr, xi) = jax.lax.scan(bwd, z0, (zr, zi, sre, sim, f.Wre, f.Wim),
                               reverse=True)
    return jax.lax.complex(xr, xi)


@jax.jit
def _factor_stacked(d4, e4, w4, n4, s4) -> SplitSublatticeFactors:
    return jax.vmap(_factor_sub_split)(d4, e4, w4, n4, s4)


@functools.partial(jax.jit, static_argnames=("stride",))
def _factor_stacked_ckpt(d4, e4, w4, n4, s4, *, stride: int):
    Wc = jax.vmap(
        lambda d, e, w, n, s: _factor_sub_ckpt(d, e, w, n, s, stride=stride)
    )(d4, e4, w4, n4, s4)
    return CkptSublatticeFactors(Wc=Wc, d=d4, e=e4, w=w4,
                                 nvals=n4, svals=s4, stride=stride)


def factor_stacked(op: HelmholtzOperator, *, checkpointed: bool = False,
                   stride: int = 32) -> StackedFactors:
    """Stacked-sublattice factorization (even Nx/Ny only)."""
    Nx, Ny = op.shape
    assert Nx % 2 == 0 and Ny % 2 == 0, "stacked factors need even N"
    coeffs = stack_coefficients(op)
    if checkpointed:
        stacked = _factor_stacked_ckpt(*coeffs, stride=stride)
    else:
        stacked = _factor_stacked(*coeffs)
    return StackedFactors(stacked=stacked, shape=(Nx, Ny))


@jax.jit
def _solve_stacked(stacked, b) -> jax.Array:
    from fdtd2d.fdfd.compressed import (
        CompressedSublatticeFactors, _solve_sub_compressed)

    if isinstance(stacked, CkptSublatticeFactors):
        solve_one = _solve_sub_ckpt
    elif isinstance(stacked, CompressedSublatticeFactors):
        solve_one = _solve_sub_compressed
    elif isinstance(stacked, SplitSublatticeFactors):
        solve_one = _solve_sub_split
    elif isinstance(stacked, SublatticeFactors):
        solve_one = _solve_sub
    else:
        raise TypeError(f"unknown stacked factor type {type(stacked)!r}")
    b4 = jnp.stack([b[px::2, py::2] for (px, py) in _PARITIES])
    x4 = jax.vmap(solve_one)(stacked, b4)
    x = jnp.zeros_like(b)
    for k, (px, py) in enumerate(_PARITIES):
        x = x.at[px::2, py::2].set(x4[k])
    return x


def solve_stacked(f: StackedFactors, b) -> jax.Array:
    """x = A^{-1} b from stacked factors; b (Nx, Ny) complex."""
    return _solve_stacked(f.stacked, b.reshape(f.shape))


# ---------------------------------------------------------------------------
# Segment-checkpointed variant: exact solves past the store-all-W memory wall
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CkptSublatticeFactors:
    """Checkpointed block-Thomas state for one sublattice: W stored only
    every ``stride`` block rows, with the tridiagonal inputs kept so
    intermediate inverses can be recomputed per segment.
    Memory: (nr/stride) * nc^2 instead of nr * nc^2 — at 2048^2 that is
    ~0.6 GB per sublattice (stride 32) instead of 8.6 GB. The price: each
    solve re-runs the inversion recursion twice (forward + backward pass),
    so this is the ONE-SHOT/large-grid path; below the memory wall use
    :func:`factor` (stored inverses, millisecond repeat solves)."""

    Wc: jax.Array       # (nseg, nc, nc) checkpoints W_{k*stride}
    d: jax.Array        # (nr, nc) tridiagonal inputs
    e: jax.Array
    w: jax.Array
    nvals: jax.Array
    svals: jax.Array
    stride: int = dataclasses.field(metadata=dict(static=True))


def _w_step(Wprev, d_r, e_r, w_r, n_r, s_rm1):
    U = _tridiag(d_r, e_r, w_r) - n_r[:, None] * Wprev * s_rm1[None, :]
    return _cinv(U)


@functools.partial(jax.jit, static_argnames=("stride",))
def _factor_sub_ckpt(d, e, w, nvals, svals, *, stride: int):
    nr = d.shape[0]
    assert nr % stride == 0, f"rows {nr} must divide the stride {stride}"
    nseg = nr // stride
    W0 = _cinv(_tridiag(d[0], e[0], w[0]))

    def row(carry, r):
        W = _w_step(carry, d[r], e[r], w[r], nvals[r], svals[r - 1])
        return W, None

    def seg(Wk, k):
        # advance stride rows from checkpoint row k*stride
        Wnext, _ = jax.lax.scan(
            row, Wk, k * stride + 1 + jnp.arange(stride))
        return Wnext, Wk

    Wend, Wc = jax.lax.scan(seg, W0, jnp.arange(nseg - 1))
    # the last segment's interior W's are recomputed at solve time from the
    # Wend checkpoint like every other segment's; nothing past it is stored
    Wc = jnp.concatenate([Wc, Wend[None]], axis=0)
    return Wc


@jax.jit
def _solve_sub_ckpt(f: CkptSublatticeFactors, b):
    """Forward pass recomputes W ascending (z_r = W_r y_r); backward pass
    recomputes each segment's W block from its checkpoint, then walks the
    segment in reverse. Two inversion sweeps per solve."""
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    nr = f.d.shape[0]
    stride = f.stride
    nseg = nr // stride

    z0 = mm(f.Wc[0], b[0])  # Wc[0] = inv(A_0)

    def fwd(carry, r):
        W, z = carry
        W = _w_step(W, f.d[r], f.e[r], f.w[r], f.nvals[r], f.svals[r - 1])
        z = mm(W, b[r] - f.nvals[r] * z)
        return (W, z), z

    W0 = f.Wc[0]  # = inv(A_0)
    (_, _), zs_rest = jax.lax.scan(fwd, (W0, z0), 1 + jnp.arange(nr - 1))
    zs = jnp.concatenate([z0[None], zs_rest], axis=0)

    def seg_ws(k):
        """(stride, nc, nc) W for rows [k*stride, (k+1)*stride)."""
        def row(carry, r):
            W = _w_step(carry, f.d[r], f.e[r], f.w[r], f.nvals[r],
                        f.svals[r - 1])
            return W, W

        Wk = f.Wc[k]
        _, Ws = jax.lax.scan(row, Wk, k * stride + 1 + jnp.arange(stride - 1))
        return jnp.concatenate([Wk[None], Ws], axis=0)

    x_last = zs[nr - 1]

    def bwd_seg(xnext, k):
        Ws = seg_ws(k)

        def bwd_row(xn, j):
            r = k * stride + j
            # the global last row's x is fixed (x_last); rows beyond use W
            x_r = zs[r] - mm(Ws[j], f.svals[r] * xn)
            return x_r, x_r

        # walk rows (k+1)*stride-1 .. k*stride in reverse; the very last
        # global row (nr-1) is handled by seeding xnext = x_last
        js = jnp.arange(stride)
        xn, xs = jax.lax.scan(bwd_row, xnext, js, reverse=True)
        return xn, xs

    # top segment: rows [(nseg-1)*stride, nr): its last row is nr-1 = x_last
    def bwd_seg_last(k):
        Ws = seg_ws(k)

        def bwd_row(xn, j):
            r = k * stride + j
            x_r = zs[r] - mm(Ws[j], f.svals[r] * xn)
            return x_r, x_r

        xn, xs = jax.lax.scan(bwd_row, x_last, jnp.arange(stride - 1),
                              reverse=True)
        return xn, jnp.concatenate([xs, x_last[None]], axis=0)

    xn, xs_top = bwd_seg_last(nseg - 1)
    xn, xs_main = jax.lax.scan(bwd_seg, xn, jnp.arange(nseg - 1),
                               reverse=True)
    # xs_main: (nseg-1, stride, nc) in segment order
    xs = jnp.concatenate([xs_main.reshape(-1, b.shape[1]), xs_top], axis=0)
    return xs


@functools.partial(jax.jit, static_argnames=("stride",))
def factor_checkpointed(op: HelmholtzOperator, stride: int = 32):
    """Checkpointed factorization of all four sublattices (even Nx/Ny only
    so every sublattice has the same row count, divisible by ``stride``)."""
    d, e, w, s, n = five_point_coefficients(op)
    subs = []
    for (px, py) in _PARITIES:
        sub = lambda a: a[px::2, py::2]
        ds, es, ws, ns, ss = sub(d), sub(e), sub(w), sub(n), sub(s)
        Wc = _factor_sub_ckpt(ds, es, ws, ns, ss, stride=stride)
        subs.append(CkptSublatticeFactors(Wc=Wc, d=ds, e=es,
                                          w=ws, nvals=ns, svals=ss,
                                          stride=stride))
    return tuple(subs)


@jax.jit
def solve_checkpointed(subs, b) -> jax.Array:
    """x = A^{-1} b from :func:`factor_checkpointed` factors; b (Nx, Ny)."""
    x = jnp.zeros_like(b)
    for (px, py), fs in zip(_PARITIES, subs):
        x = x.at[px::2, py::2].set(_solve_sub_ckpt(fs, b[px::2, py::2]))
    return x


class DirectSolver:
    """Build-once / solve-many exact solver with f64 refinement.

    The complex64 block-LU loses a few digits (no pivoting, f32 inverses);
    each :meth:`solve` wraps the factored backsolve in split-complex f64
    iterative refinement, so returned traces are TRUE f64 residuals. The
    factor cost is paid once per scene; warm solves are two scans of
    matvecs per sublattice plus one f64 residual pass per refinement round.
    """

    def __init__(self, eps, mu, dx, dy, omega, *, pml_thickness: int = 40,
                 sigma_max: float = 2.0, m: int = 3, dtype=jnp.complex64,
                 checkpointed: bool = False, stride: int = 32,
                 compressed: bool = False, rank: int = 20, leaf: int = 128,
                 power_iters: int = 1, stacked_solve: bool = True,
                 hps: bool = False, hps_leaf: int = 8):
        import numpy as np

        from fdtd2d.ops.helmholtz import make_operator
        from fdtd2d.ops.splitc import make_operator_f64

        if sum((checkpointed, compressed, hps)) > 1:
            raise ValueError("choose one of checkpointed/compressed/hps")
        self.omega = float(omega)
        self.dtype = dtype
        self.op = make_operator(eps, mu, dx, dy, self.omega,
                                pml_thickness, sigma_max, m, dtype)
        Nx, Ny = self.op.shape
        # even grids: the four sublattices stack into ONE batched scan
        # (factor AND solve) — ~4x less sequential scan latency per solve
        even = (Nx % 2 == 0) and (Ny % 2 == 0)
        if compressed:
            # past-the-memory-wall mode with FAST repeat solves: stores every
            # inverse in fixed-rank HODLR form (fdfd/compressed.py); the
            # range-finder error (sharpened by ``power_iters`` subspace
            # iterations) is absorbed by the f64 refinement
            from fdtd2d.fdfd import compressed as _comp

            nc = self.op.shape[1] // 2
            L = _comp.hodlr_plan(nc, leaf=leaf, rank=rank)
            omegas = _comp.make_test_matrices(nc, L, rank, dtype=dtype)
            # the stacked solve batches all 4 sublattice scans into one
            # program (~4x less sequential latency) but also materializes
            # ~4x the scan intermediates — pass stacked_solve=False where
            # that program does not fit the device's memory
            if even and stacked_solve:
                stacked = _comp.factor_compressed_stacked(
                    stack_coefficients(self.op), omegas, L=L, q=power_iters)
                self._solve_fn = lambda r: _solve_stacked(stacked, r)
                self._solve_base = (_solve_stacked, stacked)
                self.compressed_bytes = _comp.compressed_bytes(stacked)
                wmax = float(jnp.max(jnp.abs(stacked.rows["D"])))
            else:
                factors = _comp.factor_compressed(self.op, omegas, L=L,
                                                  q=power_iters)
                self._solve_fn = lambda r: _comp.solve_compressed(factors, r)
                self._solve_base = (_comp.solve_compressed, factors)
                self.compressed_bytes = _comp.compressed_bytes(factors)
                wmax = max(float(jnp.max(jnp.abs(s.rows["D"])))
                           for s in factors.subs)
        elif hps:
            # O(N^2 log N)-memory nested-dissection mode with log-depth
            # batched solves (fdfd/hps.py); power-of-two grids only.
            # RESEARCH MODE, 1024^2-capped: raw c64 error grows ~10x per
            # grid doubling (near-resonant interface Schur systems —
            # fdfd/hps.py module docstring), so at 2048^2+ refinement
            # cannot contract and the checkpointed/HODLR modes are the
            # exact options past the block-Thomas memory wall.
            if max(np.asarray(eps).shape) > 1024:
                import warnings

                warnings.warn(
                    "DirectSolver(hps=True) is past its measured c64 "
                    f"accuracy wall (grid {np.asarray(eps).shape}, wall "
                    "1024^2: raw error grows ~10x/doubling and refinement "
                    "stalls at 2048^2) — use checkpointed=True or "
                    "compressed=True for exact solves at this size",
                    RuntimeWarning, stacklevel=2)
            from fdtd2d.fdfd import hps as _hps

            factors = _hps.hps_factor(self.op, m=hps_leaf)
            self._solve_fn = lambda r: _hps.hps_solve(factors, r)
            self._solve_base = (_hps.hps_solve, factors)
            self.hps_bytes = _hps.factor_bytes(factors)
            # the c64 HPS solve contracts ~0.5/round at 1024^2 (near-
            # resonant interface Schur systems, see fdfd/hps.py) — it
            # needs ~21 refinement rounds where block-Thomas needs 1-2
            self._default_refine_rounds = 40
            wmax = max(float(jnp.max(jnp.abs(s.Yroot))) for s in factors.subs)
        elif checkpointed:
            # past-the-memory-wall mode (2048^2+): stores W every `stride`
            # rows; each solve re-runs the inversion recursion twice
            if even:
                stacked = _factor_stacked_ckpt(*stack_coefficients(self.op),
                                               stride=stride)
                self._solve_fn = lambda r: _solve_stacked(stacked, r)
                self._solve_base = (_solve_stacked, stacked)
                wmax = float(jnp.max(jnp.abs(stacked.Wc)))
            else:
                subs = factor_checkpointed(self.op, stride=stride)
                self._solve_fn = lambda r: solve_checkpointed(subs, r)
                self._solve_base = (solve_checkpointed, subs)
                wmax = max(float(jnp.max(jnp.abs(s.Wc))) for s in subs)
        else:
            if even:
                stacked = _factor_stacked(*stack_coefficients(self.op))
                self._solve_fn = lambda r: _solve_stacked(stacked, r)
                self._solve_base = (_solve_stacked, stacked)
                wmax = float(jnp.sqrt(jnp.max(stacked.Wre**2
                                              + stacked.Wim**2)))
            else:
                factors = factor(self.op)
                self._solve_fn = lambda r: solve_factored(factors, r)
                self._solve_base = (solve_factored, factors)
                wmax = max(float(jnp.max(jnp.abs(s.Ws)))
                           for s in factors.subs)
        # element-growth diagnostic for the pivotless recursion: ||W||_max
        # scaled by the operator's diagonal magnitude. O(1..1e3) is healthy
        # (measured ~40 on the hard 5x-binary 1024^2 scene); >>1e6 flags a
        # near-singular leading block — solve() reports it on a refine stall.
        dmax = float(jnp.max(jnp.abs(self.op.diagonal())))
        self.factor_growth = wmax * dmax
        self.op64 = make_operator_f64(np.asarray(eps), np.asarray(mu), dx, dy,
                                      self.omega, pml_thickness, sigma_max, m)

    def solve(self, source, *, rhs_scale=None, refine_target: float = 1e-6,
              max_refine_rounds: Optional[int] = None,
              return_split: bool = False, verbose: bool = False):
        """Returns ``(field, trace)`` like :meth:`TiledSolver.solve` — the
        trace holds the f64 iterate's true residual per refinement round
        plus a final entry for the returned downcast array (omitted with
        ``return_split=True``, which returns the f64 Split solution).

        ``max_refine_rounds`` defaults per factor mode: 8 for the block-
        Thomas modes (typical contraction ~1e-4/round), 40 for ``hps``
        (contraction ~0.5/round at 1024^2 — see fdfd/hps.py)."""
        import numpy as np

        from fdtd2d.fdfd.refine import refine, true_relative_residual
        from fdtd2d.ops.splitc import split_from_numpy, split_to_complex

        scale = (-1j * self.omega) if rhs_scale is None else complex(rhs_scale)
        b64 = split_from_numpy(np.asarray(source, np.complex128) * scale)
        out = refine(self.op64, b64, self._solve_fn,
                     target=refine_target,
                     max_rounds=(max_refine_rounds if max_refine_rounds
                                 is not None else
                                 getattr(self, '_default_refine_rounds', 8)),
                     inner_dtype=self.dtype)
        if float(out.relative_residual) > refine_target:
            # refine stalled: the pivotless c64 factorization did not resolve
            # a digit. Report it explicitly (with the element-growth
            # diagnostic) instead of leaving a silently-unconverged trace.
            import warnings

            warnings.warn(
                f"direct solve stalled at true residual "
                f"{float(out.relative_residual):.2e} (target {refine_target:.0e}); "
                f"factor element growth {self.factor_growth:.2e} — growth "
                f">>1e6 indicates a near-singular leading block (pivotless "
                f"block-LU); consider a PML/frequency perturbation or the "
                f"Krylov path", RuntimeWarning, stacklevel=2)
        if verbose:
            print(f"direct (refined): true res="
                  f"{float(out.relative_residual):.3e} rounds={out.rounds}")
        if return_split:
            return out.x, out.trace
        xc = split_to_complex(out.x, self.dtype)
        return xc, list(out.trace) + [true_relative_residual(
            self.op64, b64, xc)]

    def solve_batched(self, sources, *, rhs_scale=None,
                      refine_target: float = 1e-6,
                      max_refine_rounds: Optional[int] = None):
        """Solve MANY right-hand sides against the one stored factorization
        (the build-once/solve-many sweep pattern, reference fdfd.py:112) —
        returns ``(fields (B, Nx, Ny) c64, per_sample_residuals (B,),
        trace)`` where the trace holds the worst-over-batch TRUE f64
        residual per refinement round.

        The factored backsolve is two scans of batched matmuls per
        sublattice; adding a RHS axis widens those matmuls' free dimension
        (idle at B=1), and the refinement loop
        runs ONE batched f64 residual pass per round for the whole sweep —
        so a B-way sweep costs far less than B :meth:`solve` calls."""
        import numpy as np

        from fdtd2d.fdfd.refine import refine_batched
        from fdtd2d.ops.splitc import split_from_numpy, split_to_complex

        sources = np.asarray(sources, np.complex128)
        if sources.ndim != 3:
            raise ValueError(f"solve_batched wants (B, Nx, Ny) sources, "
                             f"got {sources.shape}")
        scale = (-1j * self.omega) if rhs_scale is None else complex(rhs_scale)
        b64 = split_from_numpy(sources * scale)
        if not hasattr(self, "_solve_fn_batched"):
            # the stored factors must enter the jitted program as ARGUMENTS:
            # jit inlines closure-captured device arrays as HLO constants,
            # which copies the whole factor store into the program (the
            # same rule as ops/cplx.py)
            import functools

            base_fn, base_factors = self._solve_base
            self._solve_fn_batched = functools.partial(
                jax.jit(jax.vmap(base_fn, in_axes=(None, 0))), base_factors)
        out = refine_batched(
            self.op64, b64, self._solve_fn_batched, target=refine_target,
            max_rounds=(max_refine_rounds if max_refine_rounds is not None
                        else getattr(self, '_default_refine_rounds', 8)),
            inner_dtype=self.dtype)
        worst = float(jnp.max(out.relative_residual)) if sources.shape[0] \
            else 0.0
        if worst > refine_target:
            import warnings

            warnings.warn(
                f"batched direct solve stalled at worst true residual "
                f"{worst:.2e} (target {refine_target:.0e}); factor element "
                f"growth {self.factor_growth:.2e}", RuntimeWarning,
                stacklevel=2)
        xc = split_to_complex(out.x, self.dtype)
        return xc, out.relative_residual, out.trace
