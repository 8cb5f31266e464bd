from fdtd2d.parallel.mesh import make_mesh, grid_sharding
from fdtd2d.parallel.sharded import (
    shard_operator,
    solve_fdfd_sharded,
    simulate_sharded,
    sharded_matvec_shardmap,
)
from fdtd2d.parallel.direct_sharded import (
    factor_sharded,
    solve_factored_sharded,
)
from fdtd2d.parallel.fdtd_sharded import (
    plan_sharded_kstep,
    simulate_sharded_kstep,
)
from fdtd2d.parallel.tiled_sharded import run_fdfd_tiled_sharded
from fdtd2d.parallel.timedomain_sharded import (
    TimeDomainSolverSharded,
    shard_wave_bundle,
)

__all__ = [
    "make_mesh",
    "grid_sharding",
    "shard_operator",
    "solve_fdfd_sharded",
    "simulate_sharded",
    "simulate_sharded_kstep",
    "plan_sharded_kstep",
    "sharded_matvec_shardmap",
    "run_fdfd_tiled_sharded",
    "TimeDomainSolverSharded",
    "shard_wave_bundle",
    "factor_sharded",
    "solve_factored_sharded",
]
