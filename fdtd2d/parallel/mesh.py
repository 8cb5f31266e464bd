"""Device-mesh helpers.

The reference's only "distributed" mechanism is a sequential loop over
overlapping patches in one process (reference: python-src/tiled_solver.py).
Here the grid axes are laid out over a real ``jax.sharding.Mesh``; stencil
halo exchange and solver reductions become XLA collectives between devices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("x", "y"),
              devices=None) -> Mesh:
    """Build an n-d device mesh. Default: near-square 2D over all devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if shape is None:
        rows = int(np.floor(np.sqrt(n)))
        while n % rows:
            rows -= 1
        shape = (rows, n // rows)
    assert int(np.prod(shape)) <= n, f"mesh {shape} needs more than {n} devices"
    devs = np.array(devices[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, tuple(axis_names[: len(shape)]))


def grid_sharding(mesh: Mesh, *, batch: bool = False) -> NamedSharding:
    """Sharding for (Nx, Ny) field grids (optionally with a leading batch)."""
    names = mesh.axis_names
    if batch:
        return NamedSharding(mesh, P(names[0], names[1] if len(names) > 1 else None, None))
    return NamedSharding(mesh, P(*names[:2]))
