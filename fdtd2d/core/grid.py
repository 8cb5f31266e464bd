"""Staggered Yee-grid state and scene containers.

Grid convention (matches the reference's staggering, reference:
python-src/main.py:79-85):

- ``Ez`` lives on cell nodes, shape ``(rows, cols)``.
- ``Hx`` lives on vertical edges, shape ``(rows, cols - 1)``.
- ``Hy`` lives on horizontal edges, shape ``(rows - 1, cols)``.

Everything here is a plain pytree so it jits, vmaps, and shards cleanly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from fdtd2d import constants


def grid_init(rows: int, cols: int, dtype=jnp.float32) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Zero-initialized (Ez, Hx, Hy) fields on a staggered Yee grid."""
    return (
        jnp.zeros((rows, cols), dtype),
        jnp.zeros((rows, cols - 1), dtype),
        jnp.zeros((rows - 1, cols), dtype),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Immutable simulation scene: materials + spatial resolution.

    ``eps``/``mu`` are absolute (not relative) permittivity/permeability maps
    of shape ``(rows, cols)``; ``dx`` is the (isotropic) cell size in meters.
    """

    eps: jax.Array
    mu: jax.Array
    dx: float = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return self.eps.shape

    @staticmethod
    def vacuum(rows: int, cols: int, dx: float, dtype=jnp.float32) -> "Scene":
        return Scene(
            eps=jnp.full((rows, cols), constants.EPSILON_0, dtype),
            mu=jnp.full((rows, cols), constants.MU_0, dtype),
            dx=dx,
        )

    @staticmethod
    def from_image(path: "str | None", rows: int, cols: int, dx: float,
                   black_point: float = 10.0, dtype=jnp.float32) -> "Scene":
        """Scene from a grayscale structure image (black -> black_point*eps0,
        white -> eps0; LANCZOS resize — reference python-src/main.py:88-123).
        ``path=None`` gives vacuum."""
        from fdtd2d.core.materials import material_init
        import numpy as np

        eps, mu = material_init(path, rows, cols, black_point=black_point,
                                dtype=np.float64)
        return Scene(eps=jnp.asarray(eps, dtype), mu=jnp.asarray(mu, dtype), dx=dx)

    def point_source(self, x: int, y: int, amp: float = 10.0) -> jax.Array:
        """A single-point source map at (x, y) (the drivers' convention)."""
        return jnp.zeros(self.shape, jnp.float32).at[x, y].set(amp)
