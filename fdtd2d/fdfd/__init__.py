from fdtd2d.ops.helmholtz import make_operator, HelmholtzOperator
from fdtd2d.fdfd.solver import solve_fdfd, run_fdfd, shifted_laplacian_preconditioner
from fdtd2d.fdfd.autodiff import solve_helmholtz_differentiable
from fdtd2d.fdfd.direct import (DirectSolver, factor,
                                    factor_checkpointed, solve_checkpointed,
                                    solve_direct, solve_factored)
from fdtd2d.fdfd.tiled import run_fdfd_tiled, TiledSolver
from fdtd2d.fdfd.hps import hps_factor, hps_solve
from fdtd2d.fdfd.refine import refine, RefineResult
from fdtd2d.fdfd.timedomain import TimeDomainSolver

__all__ = [
    "make_operator",
    "HelmholtzOperator",
    "solve_fdfd",
    "run_fdfd",
    "run_fdfd_tiled",
    "TiledSolver",
    "DirectSolver",
    "factor",
    "solve_direct",
    "solve_factored",
    "factor_checkpointed",
    "solve_checkpointed",
    "hps_factor",
    "hps_solve",
    "refine",
    "RefineResult",
    "TimeDomainSolver",
    "shifted_laplacian_preconditioner",
    "solve_helmholtz_differentiable",
]
