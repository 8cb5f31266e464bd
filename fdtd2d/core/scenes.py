"""Canonical benchmark/test scenes.

The GENUINELY hard scene definition is load-bearing and easy to get subtly
wrong: round 2's "5x contrast" benchmark thresholded
``gaussian_filter(standard_normal, 12)`` at 0.12 — about 5 sigma of the
blurred field — and was therefore accidentally near-uniform, which
invalidated its convergence claims. This module pins the honest recipe
(threshold a blurred uniform field at its MEDIAN → 50% duty cycle) in ONE
place; bench.py, the examples, and the tests all consume it so no copy can
drift back to an accidentally-easy scene.

The scene class matches the surrogate datagen distribution
(models/datagen.py; reference: python-src/diffusion_training.py:54-93 —
Gaussian-blurred thresholded noise, binary eps0 / 5*eps0) at benchmark
scale: the regime where the reference's sparse LU dies of fill-in and
one/two-level Schwarz methods stall, owned by the direct sublattice
factorization (fdfd/direct.py).
"""

from __future__ import annotations

import numpy as np

from fdtd2d import constants


def hard_binary_scene(N: int, *, seed: int = 7, sigma: float | None = None,
                      contrast: float = 5.0, source_xy=None,
                      source_amp: float = 1.0):
    """50%-duty binary ``contrast``x permittivity scene with a point source.

    Returns ``(eps, mu, src)`` float64 numpy arrays. ``sigma`` (feature
    size of the blurred-noise threshold mask) defaults to ``N / 64`` so
    features scale with the grid; the mask thresholds at the MEDIAN of the
    blurred field, guaranteeing a genuine 50% duty cycle at any sigma.
    """
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    blur = gaussian_filter(rng.random((N, N)),
                           sigma=N / 64 if sigma is None else sigma)
    eps = np.where(blur > np.median(blur), contrast, 1.0) * constants.EPSILON_0
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N))
    sx, sy = (N // 2, N // 2) if source_xy is None else source_xy
    src[sx, sy] = source_amp
    return eps, mu, src
