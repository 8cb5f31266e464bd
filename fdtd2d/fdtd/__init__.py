from fdtd2d.fdtd.reference import numpy_step, numpy_simulate
from fdtd2d.fdtd.step import fdtd_step, mur_coefficient
from fdtd2d.fdtd.simulate import simulate, simulate_batched, FDTDConfig

__all__ = [
    "numpy_step",
    "numpy_simulate",
    "fdtd_step",
    "mur_coefficient",
    "simulate",
    "simulate_batched",
    "FDTDConfig",
]
