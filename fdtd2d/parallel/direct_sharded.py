"""Mesh-sharded direct Helmholtz solve: sublattices distributed over devices.

The four (i mod 2, j mod 2) sublattices of the block-Thomas factorization
(fdtd2d/fdfd/direct.py) are INDEPENDENT linear systems that only meet
at the RHS split / solution merge. For even grid sizes all four have
identical (N/2, N/2) shapes, so they stack into a leading length-4 batch
axis that shards over a device mesh: `jit(vmap(...))` with the batch axis
placed on the mesh runs each sublattice's factor/solve scan on its own
device with zero communication until the final merge — factor wall-clock
and per-device W-inverse storage both drop ~4x, which moves the direct
solver's HBM ceiling from ~1024^2 per chip toward 2048^2 on a 4-device
slice (34 GB of factors -> 8.5 GB per device).

This is a third distributed leg next to the sharded FDTD kernel
(parallel/fdtd_sharded.py) and the patch-sharded Schwarz solve
(parallel/tiled_sharded.py); the reference has no distributed anything
(SURVEY.md section 2.3).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fdtd2d.ops.helmholtz import HelmholtzOperator
from fdtd2d.fdfd.compressed import (
    factor_compressed_stacked, hodlr_plan, make_test_matrices,
)
from fdtd2d.fdfd.direct import (
    StackedFactors, _factor_stacked, _factor_stacked_ckpt, _solve_stacked,
    stack_coefficients,
)

# the stacked factor/solve machinery lives in fdfd/direct.py (it is also the
# single-device fast path); this module adds the mesh placement
_stack_coefficients = stack_coefficients


def factor_sharded(op: HelmholtzOperator, mesh: Mesh, *,
                   checkpointed: bool = False, stride: int = 32,
                   compressed: bool = False, rank: int = 20,
                   leaf: int = 128, power_iters: int = 1) -> StackedFactors:
    """Factor with the sublattice axis sharded over ``mesh`` axis 0 (use 1,
    2, or 4 devices; even Nx/Ny only).

    ``checkpointed=True`` composes the two memory levers: the sublattice
    axis divides storage over devices AND W is stored only every ``stride``
    rows (fdfd/direct.py). At 4096^2 that is ~2.1 GB of checkpoints per
    device on 4 devices, vs 272 GB store-all on one — the configuration
    that makes exact hard-media solves reachable on a few devices.

    ``compressed=True`` shards the HODLR store (fdfd/compressed.py)
    instead: repeat solves stay two matvec scans (no recursion re-runs)
    while per-device memory drops by the sublattice split TIMES the HODLR
    compression — ~8.7 GB/device at 4096^2 rank 20 on 4 devices."""
    if checkpointed and compressed:
        raise ValueError("choose one of checkpointed/compressed")
    Nx, Ny = op.shape
    assert Nx % 2 == 0 and Ny % 2 == 0, "sharded direct solve needs even N"
    assert mesh.devices.ndim == 1 and 4 % mesh.devices.shape[0] == 0, \
        "use a 1D mesh of 1, 2, or 4 devices (the sublattice axis)"
    ax = mesh.axis_names[0]
    sh = NamedSharding(mesh, P(ax))
    coeffs = _stack_coefficients(op)
    coeffs = tuple(jax.device_put(c, sh) for c in coeffs)
    if checkpointed:
        stacked = _factor_stacked_ckpt(*coeffs, stride=stride)
    elif compressed:
        nc = Ny // 2
        L = hodlr_plan(nc, leaf=leaf, rank=rank)
        omegas = make_test_matrices(nc, L, rank, dtype=op.dtype)
        stacked = factor_compressed_stacked(coeffs, omegas, L=L,
                                            q=power_iters)
    else:
        stacked = _factor_stacked(*coeffs)
    return StackedFactors(stacked=stacked, shape=(Nx, Ny))


def solve_factored_sharded(f: StackedFactors, b) -> jax.Array:
    """x = A^{-1} b from sharded factors; b (Nx, Ny) complex (any layout —
    the sublattice split redistributes it)."""
    return _solve_stacked(f.stacked, b.reshape(f.shape))
