"""Mesh-sharded tiled FDFD: Schwarz patches distributed over devices.

The single-device krylov mode (fdtd2d/fdfd/tiled.py) batches all patch
solves into one vmap. Here the patch axis is sharded over a 1D device mesh
('p'): every device vmap-solves its own block of patches against its row
shard of the residual, and the overlapping write-back reduces across devices with
one ``psum_scatter`` per preconditioner application. The global operator,
the coarse FDM inverse, and the outer FGMRES run GSPMD-sharded on the same
mesh, so the whole solve is one SPMD program.

This is the reference's sequential patch loop (reference:
python-src/tiled_solver.py:190-222) reborn as actual distributed execution:
its "halo communication" (NumPy slice copies) becomes an all-gather of the
row-sharded residual + a reduce-scatter of patch contributions.

Patch count is padded to a multiple of the device count with zero-weight
dummy patches (their solves are wasted work on the last device only).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from fdtd2d.ops.helmholtz import make_operator
from fdtd2d.ops.fdm import fdm_preconditioner, fdm_preconditioner_for
from fdtd2d.ops.krylov import fgmres
from fdtd2d.fdfd.tiled import (
    generate_patches, pou_weights, patch_flat_indices,
)


def _pad_patches(origins: np.ndarray, weights: np.ndarray, D: int):
    """Pad the patch axis to a multiple of D with zero-weight copies of
    patch 0 (solved redundantly, contributing nothing)."""
    Pn = len(origins)
    pad = (-Pn) % D
    if pad:
        origins = np.concatenate([origins, np.repeat(origins[:1], pad, 0)])
        weights = np.concatenate([weights, np.zeros((pad,) + weights.shape[1:],
                                                    weights.dtype)])
    return origins, weights


def run_fdfd_tiled_sharded(
    eps, mu, dx, dy, omega, source, mesh: Mesh, *,
    patch_size: int = 100, padding: int = 30, pml_thickness: int = 10,
    global_pml_thickness: int = 40, solver_tol: float = 1e-4,
    solver_maxiter: int = 120, inner_iters: int = 8,
    dtype=jnp.complex64, refine_target: float | None = 1e-6,
    max_refine_rounds: int = 8, verbose: bool = False,
):
    """Two-level (FDM coarse + PoU-ORAS local) tiled solve, patches sharded
    over ``mesh`` axis 0. Returns (field, true-residual trace) like
    :func:`fdtd2d.fdfd.tiled.run_fdfd_tiled` mode="krylov"."""
    eps = np.asarray(eps)
    mu = np.asarray(mu)
    source = np.asarray(source)
    Nx, Ny = eps.shape
    W = patch_size + 2 * padding
    axis = mesh.axis_names[0]
    D = mesh.devices.shape[0]
    assert mesh.devices.ndim == 1, "use a 1D mesh (patch axis) for the tiled solve"
    assert Nx % D == 0, f"rows {Nx} must divide the mesh size {D}"
    real = jnp.finfo(dtype).dtype

    origins = generate_patches(Nx, Ny, patch_size, padding)
    weights_np = pou_weights(origins, W, Nx, Ny, pml_thickness, padding)
    origins, weights_np = _pad_patches(origins, weights_np, D)
    Pn = len(origins)

    gop = make_operator(eps, mu, dx, dy, float(omega),
                        pml_thickness=global_pml_thickness, dtype=dtype)
    Mg = fdm_preconditioner_for(gop)
    from fdtd2d.fdfd.tiled import stack_patch_operators

    ops_stacked = stack_patch_operators(eps, mu, origins, W, dx, dy,
                                        float(omega), pml_thickness, dtype)
    M = fdm_preconditioner(W, W, dx, dy, float(omega), pml_thickness,
                           eps_ref=float(np.mean(eps)),
                           mu_ref=1.0 / float(np.mean(1.0 / mu)), dtype=dtype)

    weights = jnp.asarray(weights_np, real)
    flat_idx = jnp.asarray(patch_flat_indices(origins, W, Ny)
                           .reshape(Pn, W * W))
    origins_dev = jnp.asarray(origins, jnp.int32)

    # place everything
    sh_p = NamedSharding(mesh, P(axis))          # patch-axis sharded
    sh_row = NamedSharding(mesh, P(axis, None))  # row-sharded grid
    sh_rep = NamedSharding(mesh, P())
    ops_sh = jax.tree.map(lambda a: jax.device_put(a, sh_p), ops_stacked)
    weights = jax.device_put(weights, sh_p)
    flat_idx = jax.device_put(flat_idx, sh_p)
    origins_dev = jax.device_put(origins_dev, sh_p)
    M_rep = jax.tree.map(lambda a: jax.device_put(a, sh_rep), M)

    from fdtd2d.ops.cplx import to_device_complex, cdot, cnorm

    b = jax.device_put(
        to_device_complex(-1j * omega * source.astype(np.complex128), dtype),
        sh_row)

    def local_oras(ops_l, wts_l, flat_l, orig_l, M_l, r_shard):
        """Per-device: gather the full residual, solve my patch block,
        scatter-reduce the weighted contributions back to row shards."""
        r_full = jax.lax.all_gather(r_shard, axis, axis=0, tiled=True)
        re, im = jnp.real(r_full), jnp.imag(r_full)

        def one_window(o):
            return (jax.lax.dynamic_slice(re, (o[0], o[1]), (W, W)),
                    jax.lax.dynamic_slice(im, (o[0], o[1]), (W, W)))

        rr, ii = jax.vmap(one_window)(orig_l)
        rloc = jax.lax.complex(rr, ii)

        def one(op, bl):
            # restart=inner_iters: fgmres cost granularity is the restart
            # cycle; no reorthogonalization for a preconditioner solve
            return fgmres(op.apply, bl, M_l, restart=inner_iters,
                          maxiter=inner_iters, tol=1e-12,
                          reorthogonalize=False).x

        sols = jax.vmap(one)(ops_l, rloc) * wts_l
        zr = jnp.zeros((Nx * Ny,), real).at[flat_l.ravel()].add(
            jnp.real(sols).ravel())
        zi = jnp.zeros((Nx * Ny,), real).at[flat_l.ravel()].add(
            jnp.imag(sols).ravel())
        zr = jax.lax.psum_scatter(zr.reshape(Nx, Ny), axis, scatter_dimension=0,
                                  tiled=True)
        zi = jax.lax.psum_scatter(zi.reshape(Nx, Ny), axis, scatter_dimension=0,
                                  tiled=True)
        return jax.lax.complex(zr, zi)

    # check_vma=False: the inner per-patch FGMRES seeds its while_loop carry
    # with replicated zeros that become device-varying inside the loop, which
    # the varying-manual-axes type check rejects; the computation is sound
    # (each device only consumes its own patches).
    oras_sharded = shard_map(
        local_oras, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P(axis, None)),
        out_specs=P(axis, None), check_vma=False)  # noqa: E501  (jax.shard_map keyword)

    @partial(jax.jit, static_argnames=("maxiter", "tol"))
    def solve_global(bb, gop, ops_sh, M_rep, Mg, weights, flat_idx,
                     origins_dev, *, maxiter, tol):
        def two_level(r):
            r2d = r.reshape(Nx, Ny)
            z1 = Mg(r2d)
            r2 = r2d - gop.apply(z1)
            z2 = oras_sharded(ops_sh, weights, flat_idx, origins_dev, M_rep, r2)
            az2 = gop.apply(z2)
            denom = cnorm(az2) ** 2
            alpha = cdot(az2, r2) / jnp.where(denom == 0, 1.0, denom)
            return z1 + alpha * z2

        return fgmres(gop.apply, bb, two_level, restart=30, maxiter=maxiter,
                      tol=tol)

    def inner_solve(rhs):
        rhs = jax.device_put(rhs, sh_row)
        return solve_global(rhs, gop, ops_sh, M_rep, Mg, weights, flat_idx,
                            origins_dev, maxiter=solver_maxiter,
                            tol=solver_tol).x

    if refine_target is not None:
        from fdtd2d.fdfd.refine import refine, true_relative_residual
        from fdtd2d.ops.splitc import (make_operator_f64,
                                           split_from_numpy, split_to_complex)

        op64 = make_operator_f64(eps, mu, dx, dy, float(omega),
                                 pml_thickness=global_pml_thickness)
        # complex128 on the host: a complex source's imaginary part must
        # reach the RHS (Split(0, -omega*source) silently dropped it)
        b64 = split_from_numpy(
            -1j * float(omega) * source.astype(np.complex128))
        out = refine(op64, b64, inner_solve, target=refine_target,
                     max_rounds=max_refine_rounds, inner_dtype=dtype)
        if verbose:
            print(f"sharded tiled (refined): true res="
                  f"{float(out.relative_residual):.3e} rounds={out.rounds}")
        xc = split_to_complex(out.x, dtype)
        # final trace entry: true residual of the RETURNED downcast array
        # (same convention as TiledSolver.solve)
        return xc, list(out.trace) + [true_relative_residual(op64, b64, xc)]

    out = solve_global(b, gop, ops_sh, M_rep, Mg, weights, flat_idx,
                       origins_dev, maxiter=solver_maxiter, tol=solver_tol)
    if verbose:
        print(f"sharded tiled: res={float(out.relative_residual):.3e} "
              f"iters={int(out.iterations)}")
    return out.x, [float(out.relative_residual)]
