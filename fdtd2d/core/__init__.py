from fdtd2d.core.grid import grid_init, Scene
from fdtd2d.core.materials import material_init, image_to_permittivity
from fdtd2d.core.sources import ricker_amplitude, sinusoidal_amplitude, point_source
from fdtd2d.core.guards import check_courant, check_resolution
from fdtd2d.core.geometry import RegionDrawer

__all__ = [
    "grid_init",
    "Scene",
    "material_init",
    "image_to_permittivity",
    "ricker_amplitude",
    "sinusoidal_amplitude",
    "point_source",
    "check_courant",
    "check_resolution",
    "RegionDrawer",
]
