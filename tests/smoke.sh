#!/bin/bash
# Pre-snapshot smoke gate (<60 s): construct + one-shot-solve every solver
# family on a tiny even grid so a broken __init__ or factor-type dispatch
# can never survive a stint again (added per round-4 verdict: the
# SplitSublatticeFactors refactor shipped with DirectSolver.__init__
# crashing on every even grid). Run this before EVERY end-of-round commit.
cd /root/repo
exec timeout 300 python - <<'EOF'
import jax
jax.config.update("jax_platforms", "cpu")
import warnings
import numpy as np
import jax.numpy as jnp

from fdtd2d import constants

N = 32  # even on purpose: the even-grid stacked path is the default mode
eps = np.full((N, N), constants.EPSILON_0)
eps[10:20, 12:22] *= 5.0
mu = np.full((N, N), constants.MU_0)
dx = dy = 1e-3
omega = 30e9
src = np.zeros((N, N), np.complex64)
src[N // 2, N // 2] = 1.0

from fdtd2d.fdfd.direct import DirectSolver, factor_stacked, solve_stacked
from fdtd2d.ops.helmholtz import make_operator

op = make_operator(jnp.asarray(eps), jnp.asarray(mu), dx, dy, omega,
                   pml_thickness=6)

checks = []

def check(name, fn):
    fn()
    checks.append(name)
    print(f"  ok {name}")

# every DirectSolver factor mode, constructed AND solved
for kwargs in ({}, {"checkpointed": True, "stride": 8},
               {"compressed": True, "leaf": 8},
               {"hps": True, "hps_leaf": 8}):
    label = "direct:" + (",".join(f"{k}={v}" for k, v in kwargs.items()) or "default")
    def run(kw=dict(kwargs)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s = DirectSolver(eps, mu, dx, dy, omega, pml_thickness=6, **kw)
            x, trace = s.solve(jnp.asarray(src), max_refine_rounds=2)
        assert np.isfinite(np.asarray(jnp.abs(x)).max())
    check(label, run)

# raw stacked API (both storage layouts)
def run_stacked():
    for ckpt in (False, True):
        f = factor_stacked(op, checkpointed=ckpt, stride=8)
        x = solve_stacked(f, jnp.asarray(src))
        assert np.isfinite(np.asarray(jnp.abs(x)).max())
check("stacked-api", run_stacked)

# odd-grid per-sublattice path
def run_odd():
    s = DirectSolver(eps[:-1, :-1].copy(), mu[:-1, :-1].copy(), dx, dy,
                     omega, pml_thickness=6)
    x, _ = s.solve(jnp.asarray(src[:-1, :-1]), max_refine_rounds=2)
    assert np.isfinite(np.asarray(jnp.abs(x)).max())
check("direct:odd-grid", run_odd)

# tiled Schwarz solver
def run_tiled():
    from fdtd2d.fdfd.tiled import TiledSolver
    s = TiledSolver(eps, mu, dx, dy, omega, patch_size=16, padding=8,
                    pml_thickness=4, global_pml_thickness=6)
    x, trace = s.solve(jnp.asarray(src), solver_maxiter=8,
                       max_refine_rounds=1)
    assert np.isfinite(np.asarray(jnp.abs(x)).max())
check("tiled", run_tiled)

# time-domain solver
def run_td():
    from fdtd2d.fdfd.timedomain import TimeDomainSolver
    s = TimeDomainSolver(eps, mu, dx, dy, omega, pml_thickness=6,
                         transits=0.5)
    x, _ = s.solve(jnp.asarray(src), max_refine_rounds=2)
    assert np.isfinite(np.asarray(jnp.abs(x)).max())
check("timedomain", run_td)

# FDTD rollout (pure-JAX backend)
def run_fdtd():
    from fdtd2d.fdtd.simulate import FDTDConfig, simulate
    cfg = FDTDConfig(dt=1e-12, dx=1e-3, nsteps=8, source_xy=(N // 2, N // 2),
                     source_fc=17e9, backend="jax")
    (Ez, Hx, Hy), _ = simulate(eps.astype(np.float32), mu.astype(np.float32), cfg)
    assert np.isfinite(np.asarray(jnp.abs(Ez)).max())
check("fdtd", run_fdtd)

print(f"SMOKE OK ({len(checks)} families)")
EOF
