"""Exact dihedral data augmentation for the scene->field surrogate.

The datagen distribution (reference python-src/diffusion_training.py:54-146)
draws SQUARE scenes with dx == dy, a symmetric PML frame on all four edges,
and uniform mu. On such grids the discrete Helmholtz outrigger operator
(ops/helmholtz.py, reference fdfd.py:14-61) is equivariant under the
dihedral group D4 of the square: central differences flip sign under index
reversal but enter the operator as C M C^T (sign squared away), the
coordinate-stretch 1/s row scalings depend only on distance to the nearest
edge (symmetric profile), and 90-degree rotation swaps the x/y difference
stencils, which the operator sums symmetrically when dx == dy. Hence for
every g in D4,

    Ez(g . scene) == g . Ez(scene)        (exactly, in exact arithmetic)

— pinned by tests/test_models.py against the exact direct solver. Applying
a random g per sample multiplies the effective number of UNIQUE scenes by
up to 8 at zero datagen cost; unique-scene count was measured as the
binding constraint on surrogate quality (10k scenes cap
holdout corr near 0.25-0.3 per seed).

The reference has no augmentation of any kind.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dihedral(x: jnp.ndarray, g) -> jnp.ndarray:
    """Apply element ``g`` in [0, 8) of D4 to the LAST TWO axes of ``x``.

    g % 4 counts 90-degree counter-clockwise rotations (as np.rot90);
    g >= 4 additionally flips the first spatial axis BEFORE rotating, i.e.
    g = 4 + k is ``rot90(flipud(x), k)``. Requires square spatial dims.
    ``g`` may be a traced scalar (lax.switch over the 8 branches)."""
    if x.shape[-1] != x.shape[-2]:
        raise ValueError(f"dihedral augmentation needs square spatial dims, "
                         f"got {x.shape[-2:]}")

    def rot(k):
        def f(v):
            for _ in range(k):
                v = jnp.flip(jnp.swapaxes(v, -2, -1), axis=-2)  # rot90 CCW
            return v
        return f

    def flip_rot(k):
        def f(v):
            return rot(k)(jnp.flip(v, axis=-2))
        return f

    branches = [rot(k) for k in range(4)] + [flip_rot(k) for k in range(4)]
    return jax.lax.switch(jnp.asarray(g, jnp.int32), branches, x)


def augment_batch(key, batch: dict, channels=("eps", "mu", "src", "Ez")) -> dict:
    """Independently transform each sample of a (B, H, W)-channel batch by a
    uniformly random element of D4, the SAME element across channels (the
    field must move with its scene). Non-spatial entries (e.g. ``omega``)
    pass through untouched."""
    B = batch[channels[0]].shape[0]
    g = jax.random.randint(key, (B,), 0, 8)
    out = dict(batch)
    for name in channels:
        if name in out:
            out[name] = jax.vmap(dihedral)(out[name], g)
    return out
