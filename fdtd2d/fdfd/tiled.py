"""Tiled FDFD: overlapping-patch domain decomposition (Schwarz methods).

Capability-equivalent of the reference's tiled solver (reference:
python-src/tiled_solver.py:111-224): overlapping patches with local PML,
halo coupling to the evolving global solution, under-relaxed write-back,
source-outward BFS ordering, early exit on max-delta.

Accelerator redesign:
- Patch windows are uniform (clamped inside the domain instead of clipped to
  ragged sizes), so ALL patch solves in a sweep batch into one ``vmap`` over
  the matrix-free Krylov solver — the reference solves patches one by one
  with scipy LU.
- The production path (``mode="krylov"`` / :class:`TiledSolver`) is a
  TWO-LEVEL preconditioner inside a global flexible GMRES, wrapped in
  split-complex f64 iterative refinement: local-PML (absorbing) patch
  solves blended through a smooth partition of unity, plus the global FDM
  coarse inverse, combined with a residual-minimizing step — converging to
  the exact global solution at the f64 floor in complex64 (the
  class docstring records the measured failure mode each ingredient
  prevents). The reference's stationary sweep plateaus at an O(0.1) field
  bias, visible in its own tiled-vs-direct plots (README.md:131-134).
- ``mode="additive"`` is the damped concurrent fixed-point sweep and
  ``mode="multiplicative"`` reproduces the reference's sequential
  source-outward update order; their Dirichlet ring clamp is imposed
  matrix-free (``x -> where(ring_mask, x, A_patch x)``, the RHS carrying
  boundary values), equivalent to the reference's LIL row surgery
  (tiled_solver.py:62-99) without materializing a matrix.
- ``fdtd2d/parallel/tiled_sharded.py`` runs the same two-level solve
  with the patch axis sharded over a device mesh.

APPLICABILITY BOUNDARY (measured, round 3): the two-level preconditioner
converges on smooth/moderate-contrast media (block scenes at 2.5x: 30
outer iterations at 1024^2) but STALLS around 0.3 relative residual on
50%-duty binary 5x media at ~lambda/8 resolution — strong multiple
scattering defeats both the uniform-medium FDM coarse level and 4-iteration
patch solves. (Round 2's "5x-binary" convergence claims used a scene that
thresholded a blurred standard normal at ~5 sigma and was accidentally
near-uniform.) The boundary also scales with ELECTRICAL SIZE (k*L): at
17 GHz a 4096^2 grid is a ~232-wavelength domain and the solve stalls
near 6e-2 relative residual even at contrast 1.5 (300-2000 outer
iterations, measured round 3; 1024^2 = 58 wavelengths converges in ~1 s
warm) — indefinite Helmholtz iteration counts grow with k*L and the
uniform-medium coarse level stops being spectrally close. For hard media
use the exact sublattice direct factorization (fdtd2d/fdfd/direct.py),
which is contrast-independent (checkpointed/compressed/sharded modes cover
the factor-memory wall); a wavelength-robust coarse space (sweeping /
multilevel) is the round-4 item for electrically-huge iterative solves.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from fdtd2d.ops.helmholtz import make_operator, HelmholtzOperator
from fdtd2d.ops.fdm import fdm_preconditioner
from fdtd2d.ops.krylov import fgmres


def generate_patches(Nx: int, Ny: int, patch_size: int, padding: int) -> np.ndarray:
    """Uniform-size patch origins: windows of W = patch_size + 2*padding
    centered like the reference's (tiled_solver.py:143-153) but clamped to
    stay inside the domain. Returns (P, 2) int array of (x0, y0)."""
    W = patch_size + 2 * padding
    assert Nx >= W and Ny >= W, f"grid {Nx}x{Ny} smaller than patch window {W}"
    xs = [min(max(0, c - W // 2), Nx - W) for c in range(patch_size // 2, Nx, patch_size)]
    ys = [min(max(0, c - W // 2), Ny - W) for c in range(patch_size // 2, Ny, patch_size)]
    xs.append(Nx - W)  # make sure the far edge is covered
    ys.append(Ny - W)
    return np.array([(x, y) for x in sorted(set(xs)) for y in sorted(set(ys))])


def bfs_order(origins: np.ndarray, W: int, source: np.ndarray, halo: int) -> np.ndarray:
    """Source-outward BFS distances over the patch-overlap graph
    (reference tiled_solver.py:159-185). Returns (P,) distances."""
    P = len(origins)
    src = np.asarray(source) != 0
    dist = np.full(P, np.iinfo(np.int32).max, np.int64)
    frontier = []
    for idx, (x0, y0) in enumerate(origins):
        if np.any(src[x0 + halo : x0 + W - halo, y0 + halo : y0 + W - halo]):
            dist[idx] = 0
            frontier.append(idx)
    d = 0
    while frontier:
        d += 1
        nxt = []
        for i in frontier:
            ax0, ay0 = origins[i]
            for j in range(P):
                if dist[j] <= d:
                    continue
                bx0, by0 = origins[j]
                if (ax0 <= bx0 + W and bx0 <= ax0 + W
                        and ay0 <= by0 + W and by0 <= ay0 + W):
                    dist[j] = d
                    nxt.append(j)
        frontier = nxt
    dist[dist == np.iinfo(np.int32).max] = d + 1
    return dist


RING_WIDTH = 2  # the distance-2 "outrigger" stencil needs a 2-cell clamp


def pou_weights(origins: np.ndarray, W: int, Nx: int, Ny: int,
                pml: int, padding: int) -> np.ndarray:
    """Smooth partition of unity over the patch cover: zero across each
    patch's local PML ring, cosine ramp over the remaining overlap, 1 in the
    core; normalized so the per-cell weights over all covering patches sum
    to 1 (0 in the thin boundary ring no core covers). Hard ownership seams
    put O(||A|| * jump) spikes into A z — measured ~9x residual
    amplification even with absorbing patch solves."""
    t1 = np.zeros(W)
    for i in range(W):
        d = min(i, W - 1 - i)
        if d <= pml:
            t1[i] = 0.0
        elif d >= padding:
            t1[i] = 1.0
        else:
            t1[i] = 0.5 * (1 - np.cos(np.pi * (d - pml) / (padding - pml)))
    wpatch = t1[:, None] * t1[None, :]
    wsum = np.zeros((Nx, Ny))
    for (x0, y0) in origins:
        wsum[x0 : x0 + W, y0 : y0 + W] += wpatch
    return np.stack([
        wpatch / np.maximum(wsum[x0 : x0 + W, y0 : y0 + W], 1e-30)
        for (x0, y0) in origins])


def patch_flat_indices(origins: np.ndarray, W: int, Ny: int) -> np.ndarray:
    """(P*W*W,) flat scatter-add indices for the overlapping write-back."""
    aw = np.arange(W)
    return ((origins[:, 0, None, None] + aw[None, :, None]) * Ny
            + (origins[:, 1, None, None] + aw[None, None, :])).ravel()


@partial(jax.jit, static_argnames=("W",))
def _extract_real_windows(a, origins_dev, *, W: int):
    """(P, W, W) windows of a real array at the given origins (module-level
    jit so repeated solves reuse one compilation)."""
    return jax.vmap(
        lambda o: jax.lax.dynamic_slice(a, (o[0], o[1]), (W, W))
    )(origins_dev)


def stack_patch_operators(eps, mu, origins: np.ndarray, W: int, dx, dy,
                          omega: float, pml_thickness: int,
                          dtype) -> HelmholtzOperator:
    """Batched local-PML patch operators as ONE HelmholtzOperator with a
    leading patch axis, built device-side: the whole eps/mu grids transfer
    once and the windows come from a vmapped dynamic_slice. (A per-patch
    Python loop of make_operator costs 2 host->device transfers per patch —
    ~3500 round-trips at 4096^2.) Every patch shares the same local
    stretch factors, broadcast along the patch axis."""
    from fdtd2d.ops.cplx import to_device_complex
    from fdtd2d.ops.helmholtz import stretch_factors

    P = len(origins)
    real = jnp.finfo(dtype).dtype
    origins_dev = jnp.asarray(origins, jnp.int32)
    eps_d = jnp.asarray(np.asarray(eps), real)
    imu_d = jnp.asarray(1.0 / np.asarray(mu), real)

    def windows(a):
        return _extract_real_windows(a, origins_dev, W=W)

    s_r, s_c = stretch_factors(W, W, float(omega), pml_thickness, 2.0, 3)
    isr = to_device_complex(np.broadcast_to(1.0 / s_r, (P, W)), dtype)
    isc = to_device_complex(np.broadcast_to(1.0 / s_c, (P, W)), dtype)
    br = lambda v: jnp.broadcast_to(jnp.asarray(v, real), (P,))
    return HelmholtzOperator(
        eps=windows(eps_d), inv_mu=windows(imu_d),
        inv_s_row=isr, inv_s_col=isc,
        omega=br(omega),
        inv_2dx=br(1.0 / (2.0 * float(dx))),
        inv_2dy=br(1.0 / (2.0 * float(dy))),
        pml_thickness=pml_thickness, sigma_max=2.0, m=3,
    )


def _ring_mask(W: int, halo: int) -> np.ndarray:
    """The Dirichlet ring: a RING_WIDTH-cell band at offset ``halo`` from the
    window edge. The reference clamps a 1-cell ring (tiled_solver.py:62-99),
    but the operator couples cells at distance 2, so a 1-cell ring lets the
    interior see the locally-PML'd halo band and the Schwarz fixed point is
    biased — its README plots show exactly that approximation error. Two
    cells shield the stencil completely."""
    rw = RING_WIDTH
    mask = np.zeros((W, W), bool)
    mask[halo : halo + rw, halo : W - halo] = True
    mask[W - halo - rw : W - halo, halo : W - halo] = True
    mask[halo : W - halo, halo : halo + rw] = True
    mask[halo : W - halo, W - halo - rw : W - halo] = True
    return mask


def _solve_patches_batched(ops_stacked, M, rings, bvals, rhs, tol, maxiter):
    """vmapped masked-Dirichlet GMRES solve over the patch batch.

    ``rings`` is a per-patch (P, W, W) clamp mask (or broadcastable stack)."""

    def one(op: HelmholtzOperator, ring, bc, b):
        def matvec(x):
            return jnp.where(ring, x, op.apply(x))

        rhs_masked = jnp.where(ring, bc, b)

        def minv(r):
            return jnp.where(ring, r, M(r))

        out = fgmres(matvec, rhs_masked, minv, restart=30, maxiter=maxiter, tol=tol)
        return out.x

    return jax.vmap(one)(ops_stacked, rings, bvals, rhs)


def _oras_apply(r2, gop, ops_k, M, weights, flat_idx, origins_dev, *,
                W: int, inner: int, real):
    """PoU-blended ORAS patch correction of a (Nx, Ny) residual (call only
    inside jit). The batched window extraction gathers real/imag
    separately (ops/cplx.py)."""
    Nx, Ny = gop.shape
    re, im = jnp.real(r2), jnp.imag(r2)

    def win(o):
        return (jax.lax.dynamic_slice(re, (o[0], o[1]), (W, W)),
                jax.lax.dynamic_slice(im, (o[0], o[1]), (W, W)))

    rr, ii = jax.vmap(win)(origins_dev)
    rloc = jax.lax.complex(rr, ii)

    def one(op, bl):
        # restart=inner: fgmres's cost granularity is the restart cycle
        # (a cycle always runs its full Arnoldi loop), so maxiter<restart
        # would silently still do 30 iterations; no reorthogonalization —
        # it's a preconditioner, 1-2 digits of local accuracy is all the
        # outer level uses
        return fgmres(op.apply, bl, M, restart=inner, maxiter=inner,
                      tol=1e-12, reorthogonalize=False).x

    sols = jax.vmap(one)(ops_k, rloc) * weights
    zr = jnp.zeros((Nx * Ny,), real).at[flat_idx].add(jnp.real(sols).ravel())
    zi = jnp.zeros((Nx * Ny,), real).at[flat_idx].add(jnp.imag(sols).ravel())
    return jax.lax.complex(zr, zi).reshape(Nx, Ny)


@partial(jax.jit,
         static_argnames=("W", "maxiter", "tol", "inner", "restart",
                          "use_patches"))
def _solve_global_two_level(bb, gop, ops_k, M, Mg, weights, flat_idx,
                            origins_dev, *, W, maxiter, tol, inner, restart,
                            use_patches: bool = True):
    """Two-level (coarse FDM + PoU-ORAS patches) preconditioned FGMRES on
    the global operator. MODULE-LEVEL jit: defining this inside the driver
    created a fresh closure per call, re-tracing and re-lowering the whole
    program every solve (~15 s per warm call at 1024^2 on the remote-compile
    stack). Complex arrays enter as jit ARGUMENTS — complex closure
    constants become HLO literals, which are unimplemented on this backend.
    """
    from fdtd2d.ops.cplx import cdot, cnorm

    Nx, Ny = gop.shape
    real = jnp.finfo(bb.dtype).dtype

    def two_level(r):
        r2d = r.reshape(Nx, Ny)
        z1 = Mg(r2d)
        if not use_patches:
            # adaptive second level (TiledSolver probe): when the
            # residual-minimizing alpha is negligible the patch solves are
            # pure per-iteration cost — the coarse level alone is the same
            # preconditioner at roughly half the price
            return z1
        r2 = r2d - gop.apply(z1)
        z2 = _oras_apply(r2, gop, ops_k, M, weights, flat_idx, origins_dev,
                         W=W, inner=inner, real=real)
        az2 = gop.apply(z2)
        denom = cnorm(az2) ** 2
        alpha = cdot(az2, r2) / jnp.where(denom == 0, 1.0, denom)
        return z1 + alpha * z2

    return fgmres(gop.apply, bb, two_level, restart=restart,
                  maxiter=maxiter, tol=tol)


@partial(jax.jit, static_argnames=("W", "inner"))
def _probe_patch_benefit(bb, gop, ops_k, M, Mg, weights, flat_idx,
                         origins_dev, *, W, inner):
    """One application of each preconditioner level on r = bb: returns the
    residual contractions (||r - A z_coarse||/||r||, ||r - A z_two||/||r||).
    TiledSolver uses the pair to decide whether the patch level pays for
    itself on this scene — it does not at mild contrast, where the measured
    residual-minimizing alpha is ~0.02 and the coarse FDM level already
    contracts by ~0.11."""
    from fdtd2d.ops.cplx import cdot, cnorm

    real = jnp.finfo(bb.dtype).dtype
    rn = cnorm(bb)
    z1 = Mg(bb)
    r2 = bb - gop.apply(z1)
    c_coarse = cnorm(r2) / rn
    z2 = _oras_apply(r2, gop, ops_k, M, weights, flat_idx, origins_dev,
                     W=W, inner=inner, real=real)
    az2 = gop.apply(z2)
    denom = cnorm(az2) ** 2
    alpha = cdot(az2, r2) / jnp.where(denom == 0, 1.0, denom)
    c_two = cnorm(r2 - alpha * az2) / rn
    return c_coarse, c_two


class TiledSolver:
    """Build-once / solve-many two-level tiled FDFD solver for one scene.

    The two-level preconditioner, each design choice pinned by measured
    contraction of ||r - A M r|| / ||r|| at 512^2 (this container):

    - Coarse level Mg: the global FDM preconditioner (exact uniform-medium
      UPML inverse). One-level patch corrections alone have no global
      coupling — on indefinite Helmholtz the outer Krylov then needs
      O(patch-count) iterations and stalls at the c64 rounding floor
      (measured: 25 patches at 512^2 stall at 0.74; 9 patches at 160^2
      converge). The cheaper PML-blind DST shifted-Laplacian coarse was
      measured and REJECTED: 150 iterations stalling at 2e-2 where FDM
      takes 30 to 4e-6 (1024^2, 5x binary contrast) — the coarse level
      must carry the PML exactly.
    - Local level: ORAS patch corrections — the patch operators carry their
      own local PML (absorbing boundaries, exactly the reference's per-patch
      construction, tiled_solver.py:47-56). Zero-Dirichlet window
      restrictions are RESONANT for indefinite Helmholtz and amplify the
      residual ~9x (measured, in c64 AND c128); local PML fixes that. Patch
      solutions are blended with a smooth partition of unity (cosine taper
      across the overlap): hard ownership seams put O(||A|| * jump) spikes
      into A z (measured amplification ~9x even with absorbing patches).
    - The local correction is applied with the residual-minimizing complex
      step z = z1 + alpha* z2, alpha* = <A z2, r - A z1> / ||A z2||^2 — at
      mild contrast the coarse level dominates (alpha ~ 0.02 measured) and
      the combined contraction equals the coarse one (0.111); at strong
      contrast, where FDM degrades, the patch solves (which see the true
      eps/mu) take over. Never worse than either level alone.

    Construction does ALL host-side setup and host->device transfer (scene
    fields, FDM eigenfactors, partition-of-unity weights, the f64 twin
    operator) — those transfers can dominate one-shot solves, so sweeps
    over sources (datagen, optimization loops)
    should hold one TiledSolver and call :meth:`solve` per source.

    Defaults (``inner_iters=2``, ``outer_restart=None`` -> min(60, ~6 GB
    of FGMRES basis)) are tuned on a genuinely
    converging 1024^2 scene (1.5x block, 17 GHz — a ~58-wavelength domain):
    warm refined solve 10.7 s vs 22 s at the old (30, 4) — FGMRES subspace
    retention (restart) dominates; a deeper patch solve adds cost, not
    contraction. NOTE the restart basis stores ``outer_restart`` full grids
    (restart * N^2 * 8 B: ~0.5 GB at 1024^2, ~8 GB at 4096^2) — lower
    ``outer_restart`` at 4096^2-class sizes. Measured applicability boundary
    at 1024^2/17 GHz: a 2.5x block stalls near 0.05 relative residual (so
    does plain-FDM FGMRES with 3000 iterations — the indefinite interior
    resonances outgrow one coarse level); use :class:`fdfd.direct
    .DirectSolver` there (contrast-independent, warm 0.73 s on the HARD
    scene).
    """

    def __init__(self, eps, mu, dx, dy, omega, *, patch_size: int = 100,
                 padding: int = 30, pml_thickness: int = 10,
                 global_pml_thickness: int = 40, dtype=jnp.complex64,
                 inner_iters: int = 2,
                 outer_restart: int | None = None,
                 _prebuilt=None):
        from fdtd2d.ops.fdm import fdm_preconditioner_for
        from fdtd2d.ops.splitc import make_operator_f64

        eps = np.asarray(eps)
        mu = np.asarray(mu)
        self.shape = eps.shape
        Nx, Ny = self.shape
        self.W = W = patch_size + 2 * padding
        self.dtype = dtype
        self.omega = float(omega)
        self.inner_iters = inner_iters
        # FGMRES retains BOTH the Krylov and the preconditioned bases:
        # (2*restart + 1) fields of N^2 * 8 B: at 4096^2 a restart of 60
        # is 16.2 GB. The default restart is min(60, ~6 GB of basis), a
        # clamp whose size on this card awaits measurement (ROADMAP A4);
        # an explicit outer_restart is honored unclamped.
        cells = int(np.prod(self.shape))
        if outer_restart is None:
            outer_restart = min(60, max(4, int(6e9 / (2 * cells * 8))))
        self.outer_restart = outer_restart
        real = jnp.finfo(dtype).dtype

        if _prebuilt is not None:
            origins, ops_stacked, M = _prebuilt
        else:
            origins = generate_patches(Nx, Ny, patch_size, padding)
            ops_stacked = stack_patch_operators(
                eps, mu, origins, W, dx, dy, self.omega, pml_thickness, dtype)
            M = fdm_preconditioner(W, W, dx, dy, self.omega, pml_thickness,
                                   eps_ref=float(np.mean(eps)),
                                   mu_ref=1.0 / float(np.mean(1.0 / mu)),
                                   dtype=dtype)
        self.ops_stacked = ops_stacked
        self.M = M
        self.gop = make_operator(eps, mu, dx, dy, self.omega,
                                 pml_thickness=global_pml_thickness,
                                 dtype=dtype)
        self.Mg = fdm_preconditioner_for(self.gop)
        self.weights = jnp.asarray(
            pou_weights(origins, W, Nx, Ny, pml_thickness, padding), real)
        # int32: with x64 enabled the default int64 indices double the
        # scatter footprint (at 4096^2 with 1764 patches that is ~360 MB)
        self.flat_idx = jnp.asarray(
            patch_flat_indices(origins, W, Ny).astype(np.int32))
        self.origins_dev = jnp.asarray(origins, jnp.int32)
        self.op64 = make_operator_f64(eps, mu, dx, dy, self.omega,
                                      pml_thickness=global_pml_thickness)
        self._patch_decision: bool | None = None  # adaptive probe cache

    def _probe_use_patches(self, b) -> bool:
        """Scene-level adaptive second level: apply each preconditioner
        level once and keep the patch corrections only when they buy a
        materially better contraction. The decision is cached — it depends
        on the scene (operator + patches), not on the RHS."""
        if self._patch_decision is None:
            cc, ct = _probe_patch_benefit(
                b, self.gop, self.ops_stacked, self.M, self.Mg,
                self.weights, self.flat_idx, self.origins_dev, W=self.W,
                inner=self.inner_iters)
            cc, ct = float(cc), float(ct)
            # skip patches only when the coarse level is already strong
            # (contraction < 0.5) AND the patch level improves it < 30%;
            # anywhere FDM degrades (hard contrast) the patches stay on
            self._patch_decision = not (cc < 0.5 and ct > 0.7 * cc)
            self._patch_probe = (cc, ct)
        return self._patch_decision

    def solve(self, source, *, rhs_scale=None, solver_tol: float = 1e-4,
              solver_maxiter: int = 300, refine_target: float | None = 1e-6,
              max_refine_rounds: int = 8, return_split: bool = False,
              adaptive: bool = True, verbose: bool = False):
        """Solve for one source. Returns ``(field, residual_trace)``; the RHS
        is ``rhs_scale * source`` (default ``-1j*omega``, the reference tiled
        convention, tiled_solver.py:57).

        With ``refine_target`` set the trace holds the f64 ITERATE's true
        residual per refinement round, PLUS a final entry: the true residual
        of the returned complex64 downcast field, which the downcast alone
        floors around eps_f32 * ||x|| (~5e-5) however far the iterate was
        refined. Pass ``return_split=True`` to get the split-complex f64
        solution itself (a :class:`~fdtd2d.ops.splitc.Split`) as
        ``field`` — then the trace carries no downcast entry.

        ``adaptive``: probe (once per scene) whether the ORAS patch level
        improves on the coarse FDM contraction; if not, solve with the
        coarse level alone — about half the per-iteration cost at mild
        contrast, identical convergence (the probe keeps patches anywhere
        they matter). Pass False to force the full two-level application.
        """
        from fdtd2d.ops.cplx import to_device_complex

        source = np.asarray(source)
        scale = (-1j * self.omega) if rhs_scale is None else complex(rhs_scale)
        b = to_device_complex(np.asarray(source, np.complex128) * scale,
                              self.dtype)
        use_patches = self._probe_use_patches(b) if adaptive else True
        if verbose and adaptive:
            cc, ct = self._patch_probe
            print(f"patch probe: coarse {cc:.3f} two-level {ct:.3f} -> "
                  f"{'two-level' if use_patches else 'coarse-only'}")

        def inner_solve(rhs):
            return _solve_global_two_level(
                rhs, self.gop, self.ops_stacked, self.M, self.Mg,
                self.weights, self.flat_idx, self.origins_dev, W=self.W,
                maxiter=solver_maxiter, tol=solver_tol,
                inner=self.inner_iters, restart=self.outer_restart,
                use_patches=use_patches).x

        if refine_target is not None:
            # mixed-precision iterative refinement: f64 split-complex
            # residuals push the TRUE residual past the c64 floor
            from fdtd2d.fdfd.refine import refine
            from fdtd2d.ops.splitc import (Split, split_to_complex)

            b_host = np.asarray(source, np.complex128) * scale
            b64 = Split(jnp.asarray(b_host.real), jnp.asarray(b_host.imag))
            out = refine(self.op64, b64, inner_solve, target=refine_target,
                         max_rounds=max_refine_rounds, inner_dtype=self.dtype)
            if verbose:
                print(f"krylov tiled (refined): true res="
                      f"{float(out.relative_residual):.3e} "
                      f"rounds={out.rounds} trace={out.trace}")
            if return_split:
                return out.x, out.trace
            from fdtd2d.fdfd.refine import true_relative_residual

            xc = split_to_complex(out.x, self.dtype)
            # honest claim: the last trace entry describes the ARRAY returned
            # (the c64 downcast), not the f64 iterate it was cut from
            return xc, list(out.trace) + [true_relative_residual(
                self.op64, b64, xc)]

        out = _solve_global_two_level(
            b, self.gop, self.ops_stacked, self.M, self.Mg, self.weights,
            self.flat_idx, self.origins_dev, W=self.W, maxiter=solver_maxiter,
            tol=solver_tol, inner=self.inner_iters, restart=self.outer_restart,
            use_patches=use_patches)
        if verbose:
            print(f"krylov tiled: res={float(out.relative_residual):.3e} "
                  f"iters={int(out.iterations)}")
        return out.x, [float(out.relative_residual)]


def run_fdfd_tiled(eps, mu, dx, dy, omega, source, *,
                   patch_size: int = 100, padding: int = 30,
                   pml_thickness: int = 10, n_passes: int = 3,
                   relax: float = 0.5, tol: float = 1e-2,
                   mode: str = "krylov", solver_tol: float = 1e-4,
                   solver_maxiter: int = 300, global_pml_thickness: int = 40,
                   inner_iters: int = 2,
                   outer_restart: int | None = None,
                   dtype=jnp.complex64,
                   refine_target: float | None = 1e-6,
                   max_refine_rounds: int = 8,
                   verbose: bool = False):
    """Multi-pass tiled FDFD solve. Returns (field, convergence_trace).

    Parameters mirror the reference driver (tiled_solver.py:117-125); the RHS
    convention is b = -1j*omega*source (tiled_solver.py:57).

    Modes:
    - "krylov" (default, production): the tiled machinery becomes the local
      level of a two-level Schwarz preconditioner (global FDM coarse solve +
      Restricted-Additive-Schwarz patch corrections) inside a global flexible
      GMRES on the true global operator (PML of ``global_pml_thickness`` at
      the domain edge) — converges to the exact global solution, unlike the
      stationary Schwarz iteration, which for indefinite Helmholtz plateaus
      at an O(0.1) bias (the approximation visible in the reference's own
      tiled-vs-direct comparison plots, README.md:131-134). When
      ``refine_target`` is not None the solve is wrapped in split-complex
      f64 iterative refinement (fdtd2d/fdfd/refine.py): ``solver_tol``
      is the per-round c64 FGMRES tolerance and ``refine_target`` the TRUE
      f64 relative-residual target; the trace returned is the per-round true
      residual of the f64 iterate plus a final entry for the returned
      (downcast) array — see :meth:`TiledSolver.solve`. Pass
      refine_target=None for the raw single-precision solve.
    - "additive": damped RAS fixed-point iteration (all patches concurrent).
    - "multiplicative": the reference's sequential source-outward sweep.
    """
    eps = np.asarray(eps)
    mu = np.asarray(mu)
    source = np.asarray(source)
    Nx, Ny = eps.shape
    W = patch_size + 2 * padding
    halo = pml_thickness

    origins = generate_patches(Nx, Ny, patch_size, padding)
    P = len(origins)

    ops_stacked = stack_patch_operators(eps, mu, origins, W, dx, dy,
                                        float(omega), pml_thickness, dtype)
    M = fdm_preconditioner(W, W, dx, dy, float(omega), pml_thickness,
                           eps_ref=float(np.mean(eps)),
                           mu_ref=1.0 / float(np.mean(1.0 / mu)), dtype=dtype)

    if mode == "krylov":
        solver = TiledSolver(
            eps, mu, dx, dy, omega, patch_size=patch_size, padding=padding,
            pml_thickness=pml_thickness,
            global_pml_thickness=global_pml_thickness, dtype=dtype,
            inner_iters=inner_iters, outer_restart=outer_restart,
            _prebuilt=(origins, ops_stacked, M))
        return solver.solve(source, solver_tol=solver_tol,
                            solver_maxiter=solver_maxiter,
                            refine_target=refine_target,
                            max_refine_rounds=max_refine_rounds,
                            verbose=verbose)

    # ------- stationary-mode-only setup (the reference's own algorithm) -----
    # The O(P * Nx * Ny) host-side ownership map below is a stationary-sweep
    # artifact; keeping it out of the krylov path matters at scale (at 4096^2
    # with ~1700 patches it is tens of host GFLOPs).
    dists = bfs_order(origins, W, source, halo)
    order = np.argsort(dists, kind="stable")
    ring = jnp.asarray(_ring_mask(W, halo))
    inner = slice(halo + RING_WIDTH, W - halo - RING_WIDTH)

    from fdtd2d.ops.cplx import to_device_complex as _tdc

    rhs = jnp.stack([
        _tdc(-1j * omega * source[x0 : x0 + W, y0 : y0 + W].astype(np.complex128), dtype)
        for (x0, y0) in origins
    ])

    from fdtd2d.ops.cplx import czeros

    solution = czeros((Nx, Ny), dtype)

    # RAS ownership: each cell belongs to the patch (among those whose
    # interior covers it) with the nearest window center.
    owner = np.full((Nx, Ny), -1, np.int32)
    best = np.full((Nx, Ny), np.inf)
    gx, gy = np.mgrid[0:Nx, 0:Ny]
    for p, (x0, y0) in enumerate(origins):
        cx, cy = x0 + W / 2, y0 + W / 2
        d2 = (gx - cx) ** 2 + (gy - cy) ** 2
        h2 = halo + RING_WIDTH  # exclude the clamped ring from ownership
        covers = ((gx >= x0 + h2) & (gx < x0 + W - h2)
                  & (gy >= y0 + h2) & (gy < y0 + W - h2))
        better = covers & (d2 < best)
        owner[better] = p
        best[better] = d2[better]
    owner_valid = jnp.asarray(owner >= 0)
    ox = origins[:, 0][np.maximum(owner, 0)]
    oy = origins[:, 1][np.maximum(owner, 0)]
    owner_idx = jnp.asarray(np.maximum(owner, 0))
    owner_lx = jnp.asarray(gx - ox)
    owner_ly = jnp.asarray(gy - oy)

    solve = jax.jit(partial(_solve_patches_batched, tol=solver_tol,
                            maxiter=solver_maxiter))
    solve_one = jax.jit(lambda op, M, ring, bc, b: _solve_patches_batched(
        jax.tree.map(lambda x: x[None], op), M, ring[None], bc[None], b[None],
        solver_tol, solver_maxiter)[0])

    deltas = []
    for sweep in range(n_passes):
        if mode == "additive":
            bvals = jnp.stack([
                solution[x0 : x0 + W, y0 : y0 + W] for (x0, y0) in origins
            ])
            sols = solve(ops_stacked, M, jnp.broadcast_to(ring, (P, W, W)), bvals, rhs)
            # Restricted Additive Schwarz write-back: each cell is owned by
            # exactly one patch (nearest window center) — a partition of
            # unity, which converges far better than overlap-averaging.
            from fdtd2d.ops.cplx import cgather

            new = jnp.where(owner_valid,
                            cgather(sols, owner_idx, owner_lx, owner_ly), solution)
            max_delta = float(jnp.max(jnp.abs(new - solution)))
            solution = (1.0 - relax) * solution + relax * new
        else:  # multiplicative: reference's sequential source-outward order
            max_delta = 0.0
            for p in order:
                x0, y0 = origins[p]
                bc = solution[x0 : x0 + W, y0 : y0 + W]
                sol = solve_one(jax.tree.map(lambda x: x[p], ops_stacked),
                                M, ring, bc, rhs[p])
                h2 = halo + RING_WIDTH
                tgt = solution[x0 + h2 : x0 + W - h2, y0 + h2 : y0 + W - h2]
                new = sol[inner, inner]
                max_delta = max(max_delta, float(jnp.max(jnp.abs(new - tgt))))
                blended = (1.0 - relax) * tgt + relax * new
                solution = solution.at[x0 + h2 : x0 + W - h2,
                                       y0 + h2 : y0 + W - h2].set(blended)
        deltas.append(max_delta)
        if verbose:
            print(f"sweep {sweep + 1}: max_delta={max_delta:.3e}")
        if max_delta < tol:
            break
    return solution, deltas
