"""Material maps: uniform media and grayscale-image ingestion.

Semantics follow the reference (reference: python-src/main.py:88-123):
a grayscale image is resized with LANCZOS filtering to the grid shape;
black pixels map to ``black_point * eps0`` (high permittivity), white pixels
to ``eps0``; permeability is always uniform ``mu0``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from fdtd2d import constants


def image_to_permittivity(
    path: str, rows: int, cols: int, black_point: float = 10.0
) -> np.ndarray:
    """Rasterize a grayscale image into a relative-permittivity factor map.

    Returns the factor array in ``[1, black_point]`` (multiply by eps0 to get
    absolute permittivity).
    """
    from PIL import Image

    img = Image.open(path).convert("L")
    img = img.resize((cols, rows), Image.LANCZOS)
    level = np.asarray(img, dtype=np.float64) / 255.0
    return 1.0 + (black_point - 1.0) * (1.0 - level)


def material_init(
    path: Optional[str],
    rows: int,
    cols: int,
    black_point: float = 10.0,
    dtype=np.float64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (eps, mu) material maps, optionally from a grayscale image.

    With ``path=None`` the medium is vacuum everywhere.
    """
    mu = np.full((rows, cols), constants.MU_0, dtype=dtype)
    if path is None:
        eps = np.full((rows, cols), constants.EPSILON_0, dtype=dtype)
    else:
        eps = (image_to_permittivity(path, rows, cols, black_point) * constants.EPSILON_0).astype(dtype)
    return eps, mu
