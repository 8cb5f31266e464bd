"""Benchmark suite: one JSON line per metric, HEADLINE LAST.

Covers the solver stack:

    fdtd4096     FDTD at 4096^2, ``auto`` backend (the K-step CUDA kernel on
                 a GPU), GCells/s
    fdtd8192     same at 8192^2 (1.3 GB of fields), GCells/s
    fdfd512      exact block-Thomas warm solve to 1e-6 true residual
                 (build-once excluded, reported as factor_s), seconds
    fdfd512iter  FDM-FGMRES complex64 steady-state solve, seconds
    direct1024   exact sublattice block-Thomas solve, HARD 50%-duty binary
                 5x scene, warm repeat-solve seconds (factors reused)
    direct1024batched  amortized per-source exact solve: one factorization,
                 16-source sweep via solve_batched, seconds/source
    direct2048   HODLR-compressed exact solve at 2048^2, seconds
    tiled1024    two-level ORAS tiled solve, moderate-contrast scene, warm
                 repeat-solve seconds (TiledSolver build excluded — the
                 build-once/solve-many production pattern)
    tiled1024approx  same scene solved to the REFERENCE's accuracy class
                 (1e-2 relative residual, no refinement) — the direct
                 apples-to-apples row against its ~3 s claim
    timedomain4096  frequency-locked time-domain solve at 4096^2 / 17 GHz
                 (~232 wavelengths, contrast 1.5), warm repeat to 1e-6 TRUE
                 residual, seconds
    datagen      vmapped on-device surrogate datagen (exact direct labels),
                 samples/s
    trainstep    diffusion-surrogate train step, ms (batch 8 @ 256^2):
                 a 32-step lax.scan epoch in ONE dispatch, + XLA-cost-model
                 FLOP/s over the card's published peak
    trainstepbf16  same step in the bf16 mixed-precision configuration
    fdtd2048     FDTD at 2048^2, ``auto`` backend, GCells/s  <- headline, LAST

Each bench runs in its own child process, one at a time, from a parent
that never imports JAX (one process per card). A child that fails or runs
past FDTD2D_BENCH_TIMEOUT is reported and the suite exits non-zero: a
failure on the card is a finding, not something to retry. Every line
carries the device as JAX reports it and the card's name and power limit
as nvidia-smi reports them.

Sizes are the real ones on a GPU. Without a GPU a child fails, unless the
run asks for the CPU explicitly (``--cpu``): then toy sizes run, for
checking the harness only; their numbers are no device metric.

Baselines are the reference's own kernels measured on a CPU (BASELINE.md):
NumPy FDTD 17.7 MCells/s at 2048^2, scipy spsolve 7.1 s at 512^2, the
reference README's ~3 s approximate tiled solve at 1000^2 (README.md:135),
and its ~0.72 s/sample FDFD datagen at 256^2.

Usage: python bench.py [--only name1,name2] [--cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FDTD_BASELINE = 0.0177          # GCells/s, reference NumPy kernels (BASELINE.md)
FDFD512_BASELINE_S = 7.1        # scipy spsolve at 512^2 (BASELINE.md)
TILED1024_BASELINE_S = 3.0      # reference ~3 s APPROXIMATE tiled solve at 1000^2
# reference exact solve at 1000^2: ~20 s spsolve per SOURCE (README.md:135;
# scipy.sparse.linalg.spsolve re-factors on every call, so a source sweep
# pays the full ~20 s each time — reference fdfd.py:112)
DIRECT1024_BASELINE_S = 20.0
TD4096_TRANSITS = 2.5           # timedomain settle budget
DIRECT2048_RANK = 20            # HODLR rank/range-finder passes from
DIRECT2048_Q = 1                # examples/direct2048_fast_probe.py
DATAGEN_BASELINE_SPS = 1.0 / 0.72  # reference: one 256^2 spsolve per sample
# reference's own torch train step (UNet2DModel fwd+bwd+AdamW, batch 8 at
# 256^2) measured on a CPU (BASELINE.md; the
# reference published no training-time numbers)
TRAINSTEP_BASELINE_MS = 99708.0


# Published dense peaks per device kind (NVIDIA H100 SXM data sheet; the
# rates assume the full 700 W power limit, and every bench line records the
# card's actual limit). A device kind missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "tf32_tflops": 495.0,
                              "fp32_tflops": 67.0, "hbm_tb_s": 3.35},
}


def peak_for(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no published peak for device kind {device_kind!r}; "
                         "add it to bench.PEAKS with its source") from None


def _fdtd(N: int, steps: int, backend: str, reps: int = 3):
    import jax
    import jax.numpy as jnp

    from fdtd2d import constants
    from fdtd2d.fdtd.simulate import simulate, FDTDConfig

    eps = np.full((N, N), constants.EPSILON_0, np.float32)
    eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
    eps = jnp.asarray(eps)
    mu = jnp.full((N, N), constants.MU_0, jnp.float32)
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=steps,
                     source_xy=(N // 2, N // 2), source_fc=30e9,
                     backend=backend)
    state, _ = simulate(eps, mu, cfg)
    jax.block_until_ready(state[0])
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        state, _ = simulate(eps, mu, cfg, state=state)
        jax.block_until_ready(state[0])
        best = max(best, N * N * steps / (time.perf_counter() - t0) / 1e9)
    return best


def bench_fdtd2048(full):
    N, steps = (2048, 6000) if full else (512, 50)
    v = _fdtd(N, steps, "auto", reps=4)
    return {"metric": f"fdtd_yee_updates_{N}x{N}", "value": round(v, 3),
            "unit": "GCells/s", "vs_baseline": round(v / FDTD_BASELINE, 1)}


def bench_fdtd4096(full):
    N, steps = (4096, 2048) if full else (256, 32)
    v = _fdtd(N, steps, "auto")
    return {"metric": f"fdtd_yee_updates_{N}x{N}_auto", "value": round(v, 3),
            "unit": "GCells/s", "vs_baseline": round(v / FDTD_BASELINE, 1)}


def bench_fdtd8192(full):
    N, steps = (8192, 512) if full else (256, 32)
    v = _fdtd(N, steps, "auto")
    return {"metric": f"fdtd_yee_updates_{N}x{N}_auto", "value": round(v, 3),
            "unit": "GCells/s", "vs_baseline": round(v / FDTD_BASELINE, 1)}


def _fdfd512_scene(N: int, omega: float):
    from fdtd2d import constants

    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3 : 2 * N // 3, N // 4 : N // 2] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N), np.complex128)
    src[N // 2, N // 2] = -1j * omega
    return eps, mu, src


def bench_fdfd512(full):
    """FDFD 512^2 solve to 1e-6 TRUE residual via the exact sublattice
    block-Thomas factorization: build-once (untimed, reported as factor_s)
    + warm repeat solve — the reference's own build-once/solve-many spsolve
    pattern (fdfd.py:112), same timing contract as direct1024/tiled1024.
    The iterative solve of this scene stays as fdfd512iter; the FDM
    preconditioner's contrast sensitivity makes it the weaker of the two."""
    from fdtd2d.fdfd.direct import DirectSolver

    N, dx, omega = (512, 1e-3, 17e9) if full else (128, 1e-3, 17e9)
    eps, mu, src = _fdfd512_scene(N, omega)
    # rhs_scale=1.0: the scene's src already carries the -1j*omega factor
    # (the iterative bench consumes it as the raw RHS); the default scale
    # would apply -1j*omega AGAIN — b ~ 3e20, whose squared norms overflow
    # the f32 exponent range of the f32-pair arithmetic (ops/splitc.snorm)
    kw = dict(rhs_scale=1.0, refine_target=1e-6)
    t_f = time.perf_counter()
    solver = DirectSolver(eps, mu, dx, dx, omega)
    _, trace = solver.solve(src, **kw)   # compile + warm
    factor_s = time.perf_counter() - t_f
    t0 = time.perf_counter()
    _, trace = solver.solve(src, **kw)
    dt = time.perf_counter() - t0
    assert trace[-2] < 1e-5, f"direct 512^2 solve did not converge: {trace}"
    return {"metric": f"fdfd_{N}sq_solve", "value": round(dt, 3),
            "unit": "s", "vs_baseline": round(FDFD512_BASELINE_S / dt, 1),
            "factor_s": round(factor_s, 2)}


def bench_fdfd512_iter(full):
    import jax
    import jax.numpy as jnp

    from fdtd2d.fdfd.solver import solve_fdfd, resolve_preconditioner
    from fdtd2d.ops.helmholtz import make_operator

    N, dx, omega = (512, 1e-3, 17e9) if full else (128, 1e-3, 17e9)
    eps, mu, src = _fdfd512_scene(N, omega)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=40)
    from fdtd2d.ops.cplx import to_device_complex

    b = to_device_complex(src, jnp.complex64)
    M, _ = resolve_preconditioner(op, "fdm")
    # restart=20: fgmres cost granularity is the RESTART CYCLE (a cycle
    # always runs its full Arnoldi loop — ops/krylov.py), so the default 40
    # wastes up to 39 iterations past convergence; 20 keeps margin for
    # harder scenes (the best restart on this card: ROADMAP A4).
    kw = dict(preconditioner=M, tol=1e-6, maxiter=3000, restart=20)
    res = solve_fdfd(op, b, **kw)   # compile + converge once
    jax.block_until_ready(res.x)
    t0 = time.perf_counter()
    res = solve_fdfd(op, b, **kw)
    jax.block_until_ready(res.x)
    dt = time.perf_counter() - t0
    assert float(res.relative_residual) < 1e-4, float(res.relative_residual)
    return {"metric": f"fdfd_{N}sq_iterative_solve", "value": round(dt, 3),
            "unit": "s", "vs_baseline": round(FDFD512_BASELINE_S / dt, 1)}


def _contrast_scene(N: int, seed: int = 7):
    """Deterministic 50%-duty binary 5x-contrast scene (the datagen
    distribution at benchmark scale — the regime where the reference's LU
    dies of fill-in, plain FDM stalls, AND the two-level ORAS stalls at
    ~0.3; only the sublattice direct factorization solves it). The honest
    recipe is pinned once in core/scenes.py."""
    from fdtd2d.core.scenes import hard_binary_scene

    return hard_binary_scene(N, seed=seed)


def _block_scene(N: int, contrast: float = 2.5):
    """Moderate-contrast block scene. Measured boundary at 1024^2/17 GHz
    (a ~58-wavelength domain): contrast 2.5 stalls near 0.05 relative
    residual for BOTH the two-level tiled solver and plain FDM-FGMRES at
    3000 iterations — interior block resonances outgrow one coarse level;
    contrast 1.5 converges to 1e-9 true residual. The tiled bench therefore
    runs contrast 1.5 (the regime the iterative path honestly owns);
    2.5x-and-up at this size belongs to the direct solver (bench_direct1024,
    which runs a HARDER 50%-duty binary 5x scene)."""
    from fdtd2d import constants

    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3 : 2 * N // 3, N // 4 : N // 2] *= contrast
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N))
    src[N // 2, N // 2] = 1.0
    return eps, mu, src


def bench_direct1024(full):
    """Exact sublattice block-Thomas solve on the HARD binary scene:
    build-once (untimed) + warm repeat solve to 1e-6 true residual."""
    from fdtd2d.fdfd.direct import DirectSolver

    N, omega = (1024, 17e9) if full else (128, 17e9)
    dx = 1e-3
    eps, mu, src = _contrast_scene(N)
    solver = DirectSolver(eps, mu, dx, dx, omega)
    _, trace = solver.solve(src, refine_target=1e-6)   # compile + warm
    t0 = time.perf_counter()
    _, trace = solver.solve(src, refine_target=1e-6)
    dt = time.perf_counter() - t0
    assert trace[-2] < 1e-5, f"direct solve did not converge: {trace}"
    return {"metric": f"direct_{N}sq_hard_contrast_warm_solve",
            "value": round(dt, 3), "unit": "s",
            "vs_baseline": round(TILED1024_BASELINE_S / dt, 2)}


def bench_direct1024_batched(full):
    """Amortized per-source exact solve on the HARD binary scene: one stored
    factorization, a 16-source sweep through DirectSolver.solve_batched
    (one joint batched f64 refinement loop — the build-once/solve-many
    pattern the reference pays ~20 s/source for, since spsolve re-factors
    on every call, reference fdfd.py:112). Reports seconds PER SOURCE."""
    from fdtd2d.fdfd.direct import DirectSolver

    N, omega, B = (1024, 17e9, 16) if full else (128, 17e9, 4)
    dx = 1e-3
    eps, mu, src = _contrast_scene(N)
    rng = np.random.default_rng(0)
    ij = rng.integers(N // 4, 3 * N // 4, size=(B, 2))
    srcs = np.zeros((B, N, N))
    srcs[np.arange(B), ij[:, 0], ij[:, 1]] = 1.0
    solver = DirectSolver(eps, mu, dx, dx, omega)
    _, res, _ = solver.solve_batched(srcs, refine_target=1e-6)  # compile+warm
    t0 = time.perf_counter()
    _, res, _ = solver.solve_batched(srcs, refine_target=1e-6)
    dt = (time.perf_counter() - t0) / B
    worst = float(np.max(np.asarray(res)))
    assert worst < 1e-5, f"batched direct solve did not converge: {worst}"
    return {"metric": f"direct_{N}sq_batched{B}_warm_per_source",
            "value": round(dt, 3), "unit": "s",
            "vs_baseline": round(DIRECT1024_BASELINE_S / dt, 1)}


def bench_direct2048(full):
    """Fast exact repeat solves PAST the store-all-W factor-memory wall
    (34 GB at 2048^2 — fdfd/direct.py): HODLR-compressed factors
    (fdfd/compressed.py) with the probe configuration
    (examples/direct2048_fast_probe.py: power-iteration range finder q=1 +
    rank bump so refinement needs ~2 rounds instead of 8, stacked
    sublattice scans). Warm repeat solve to 1e-6 TRUE f64 residual on the
    HARD 50%-duty binary 5x scene. vs_baseline is null: the reference's
    spsolve hits the LU fill-in wall at ~1000^2 (README.md:135)."""
    from fdtd2d.core.scenes import hard_binary_scene
    from fdtd2d.fdfd.direct import DirectSolver

    N, omega = (2048, 17e9) if full else (128, 17e9)
    dx = 1e-3
    eps, mu, src = hard_binary_scene(N, seed=3, source_amp=10.0)
    solver = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=40,
                          compressed=True, rank=DIRECT2048_RANK,
                          leaf=128, power_iters=DIRECT2048_Q,
                          # per-sublattice loop solves: the stacked solve
                          # program's footprint at this size on this card
                          # is not measured yet (ROADMAP A4)
                          stacked_solve=False)
    _, trace = solver.solve(src, refine_target=1e-6)   # compile + warm
    t0 = time.perf_counter()
    _, trace = solver.solve(src, refine_target=1e-6)
    dt = time.perf_counter() - t0
    assert trace[-2] < 1e-5, f"direct 2048 solve did not converge: {trace}"
    return {"metric": f"direct_{N}sq_compressed_warm_solve",
            "value": round(dt, 3), "unit": "s", "vs_baseline": None,
            "store_gb": round(solver.compressed_bytes / 1e9, 2),
            "rounds": len(trace) - 2}


def bench_tiled1024(full):
    """Two-level tiled warm solve at 1024^2, contrast 1.5 (see _block_scene
    for the measured boundary). vs_baseline compares against the reference's
    ~3 s 1000^2 tiled number (README.md:135) with the caveat that the
    reference's solve is APPROXIMATE (stationary sweep, O(10%) field bias)
    while this one is exact to 1e-6 TRUE f64 residual; the apples-to-apples
    1024^2 exact-solve row is bench_direct1024."""
    from fdtd2d.fdfd.tiled import TiledSolver

    N, omega = (1024, 17e9) if full else (160, 17e9)
    dx = 1e-3
    eps, mu, src = _block_scene(N, contrast=1.5)
    solver = TiledSolver(eps, mu, dx, dx, omega)
    kw = dict(solver_tol=1e-4, solver_maxiter=300, refine_target=1e-6)
    _, trace = solver.solve(src, **kw)      # compile + warm
    t0 = time.perf_counter()
    _, trace = solver.solve(src, **kw)
    dt = time.perf_counter() - t0
    assert trace[-2] < 1e-5, f"tiled solve did not converge: {trace}"
    return {"metric": f"tiled_{N}sq_exact_warm_solve", "value": round(dt, 3),
            "unit": "s", "vs_baseline": round(TILED1024_BASELINE_S / dt, 2)}


def bench_tiled1024_approx(full):
    """Apples-to-apples row vs the reference's ~3 s tiled claim: same scene
    class and size, solved to 1e-2 RELATIVE RESIDUAL (a stronger bound than
    the reference's tol=1e-2 on the iterate delta, which leaves O(10%) field
    bias — tiled_solver.py:214-222). No refinement; small restart because
    fgmres cost granularity is the restart cycle (ops/krylov.py)."""
    from fdtd2d.fdfd.tiled import TiledSolver

    N, omega = (1024, 17e9) if full else (160, 17e9)
    dx = 1e-3
    eps, mu, src = _block_scene(N, contrast=1.5)
    solver = TiledSolver(eps, mu, dx, dx, omega, outer_restart=10)
    kw = dict(solver_tol=1e-2, solver_maxiter=60, refine_target=None)
    _, trace = solver.solve(src, **kw)      # compile + warm
    t0 = time.perf_counter()
    _, trace = solver.solve(src, **kw)
    dt = time.perf_counter() - t0
    assert trace[-1] < 1e-2, f"tiled approx solve did not converge: {trace}"
    return {"metric": f"tiled_{N}sq_refaccuracy_warm_solve",
            "value": round(dt, 3), "unit": "s",
            "vs_baseline": round(TILED1024_BASELINE_S / dt, 2)}




def bench_timedomain4096(full):
    """Wavelength-robust solve at the iterative solvers' stall point: 4096^2 / 17 GHz
    (~232 wavelengths across), contrast 1.5 — where the two-level ORAS
    tiled solver stalls near 6e-2 relative residual (fdfd/tiled.py) and
    the stored-factor direct modes exceed one card's memory. The frequency-
    locked time-domain solver (fdfd/timedomain.py) needs NO stored
    factors; warm repeat solve (build excluded) to 1e-6 TRUE f64
    residual. vs_baseline is null: the reference has no solver that
    reaches this size at all (its spsolve hits the LU fill-in wall at
    ~1000^2, README.md:135)."""
    from fdtd2d.fdfd.timedomain import TimeDomainSolver

    N, omega = (4096, 17e9) if full else (192, 30e9)
    dx = 1e-3
    eps, mu, src = _block_scene(N, contrast=1.5)
    solver = TimeDomainSolver(eps, mu, dx, dx, omega,
                              transits=TD4096_TRANSITS if full else 4.0)
    _, trace = solver.solve(src, refine_target=1e-6)   # compile + warm
    t0 = time.perf_counter()
    _, trace = solver.solve(src, refine_target=1e-6)
    dt = time.perf_counter() - t0
    assert trace[-2] < 1e-6, f"timedomain did not converge: {trace}"
    return {"metric": f"timedomain_{N}sq_warm_solve", "value": round(dt, 2),
            "unit": "s", "vs_baseline": None,
            "steps_per_apply": solver.steps_per_apply,
            "rounds": len(trace) - 2}


def bench_datagen(full):
    import jax

    from fdtd2d.models.datagen import generate_batch

    size, batch = ((256, 256), 32) if full else ((64, 64), 8)
    out = generate_batch(jax.random.PRNGKey(0), batch=batch, shape=size)
    jax.block_until_ready(out["Ez"])
    t0 = time.perf_counter()
    out = generate_batch(jax.random.PRNGKey(1), batch=batch, shape=size)
    jax.block_until_ready(out["Ez"])
    sps = batch / (time.perf_counter() - t0)
    worst = float(np.max(np.asarray(out["residuals"])))
    assert worst < 1e-4, f"datagen labels unconverged: {worst:.1e}"
    return {"metric": f"datagen_{size[0]}sq_samples_per_s",
            "value": round(sps, 2), "unit": "samples/s",
            "vs_baseline": round(sps / DATAGEN_BASELINE_SPS, 1)}


def bench_trainstep(full, compute_dtype="float32"):
    # ONE big dispatched batch — a lax.scan of nb train steps
    # (train_epoch) — ended by block_until_ready on the loss and the params:
    # timing a Python loop of single-step dispatches measures the enqueue.
    import jax
    import jax.numpy as jnp

    from fdtd2d.models.diffusion import DDPMSchedule
    from fdtd2d.models.train import TrainConfig, create_state, train_epoch

    H = 256 if full else 64
    B = 8
    nb = 32                      # steps per timed dispatch
    n = nb * B
    cfg = TrainConfig(batch_size=B, compute_dtype=compute_dtype)
    state = create_state(jax.random.PRNGKey(0), (H, H), cfg)
    schedule = DDPMSchedule.create(cfg.num_train_timesteps)
    k = jax.random.PRNGKey(1)
    data = {name: jax.random.normal(jax.random.fold_in(k, i), (n, H, H),
                                    jnp.float32)
            for i, name in enumerate(("eps", "mu", "src", "Ez"))}
    data["omega"] = jnp.full((n,), 2.4, jnp.float32)
    perm = jnp.arange(n)
    kwargs = dict(batch_size=B)
    s1, loss = train_epoch(state, schedule, k, data, perm, **kwargs)  # compile
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    s2, loss = train_epoch(state, schedule, k, data, perm, **kwargs)
    # the epoch-mean loss depends on every step's state; add a param fetch
    # so the final optimizer update is forced too
    jax.block_until_ready(loss)
    jax.block_until_ready(jax.tree.leaves(s2.params)[0])
    ms = (time.perf_counter() - t0) / nb * 1e3

    # FLOP/s from XLA's own cost model (per-epoch program) over the card's
    # published peak: TF32 for float32 (XLA's default for f32 convolutions
    # on this card), bf16 for the mixed-precision configuration
    # (XLA:GPU's cost model can report no flops for the scanned program:
    # the figure is then left out, not written as zero)
    mfu = None
    if full:
        compiled = train_epoch.lower(state, schedule, k, data, perm,
                                     **kwargs).compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        flops = float((cost or {}).get("flops", 0.0))
        peak = peak_for(jax.devices()[0].device_kind)[
            "tf32_tflops" if compute_dtype == "float32" else "bf16_tflops"]
        if flops > 0:
            mfu = flops / ((ms / 1e3) * nb) / (peak * 1e12)
    tag = "" if compute_dtype == "float32" else "_bf16"
    out = {"metric": f"train_step_b{B}_{H}sq{tag}", "value": round(ms, 2),
           "unit": "ms",
           # reference's own torch train step (same batch/shape) measured on
           # a CPU (BASELINE.md)
           "vs_baseline": (round(TRAINSTEP_BASELINE_MS / ms, 1)
                           if full else None)}
    if mfu is not None:
        out["flops_vs_peak"] = round(mfu, 4)
    return out


# headline LAST: the driver parses the final line
BENCHES = [
    ("fdtd4096", bench_fdtd4096),
    ("fdtd8192", bench_fdtd8192),
    ("fdfd512", bench_fdfd512),
    ("fdfd512iter", bench_fdfd512_iter),
    ("direct1024", bench_direct1024),
    ("direct1024batched", bench_direct1024_batched),
    ("direct2048", bench_direct2048),
    ("tiled1024", bench_tiled1024),
    ("tiled1024approx", bench_tiled1024_approx),
    ("timedomain4096", bench_timedomain4096),
    ("datagen", bench_datagen),
    ("trainstep", bench_trainstep),
    # mixed-precision configuration for the surrogate runs (bf16
    # conv/dense math, f32 master params/BatchNorm/head/loss)
    ("trainstepbf16",
     lambda full: bench_trainstep(full, compute_dtype="bfloat16")),
    ("fdtd2048", bench_fdtd2048),
]


def card() -> str | None:
    """The card's name and power limit as nvidia-smi reports them (no JAX
    in this process), or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def run_child(name: str, cpu: bool) -> None:
    if name == "_hang":
        # hidden host-only bench that never returns: exercises the parent's
        # hung-child timeout without touching jax or the device
        time.sleep(3600)
        return
    if name == "_fail":
        # hidden host-only bench that fails: exercises the suite's exit code
        raise RuntimeError("deliberate failure")
    import jax

    from fdtd2d.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not cpu:
        raise SystemExit(f"no GPU found (platform {dev.platform!r}); pass "
                         "--cpu for a harness check at toy sizes")
    row = dict(BENCHES)[name](dev.platform == "gpu")
    row.update(platform=dev.platform, device_kind=dev.device_kind,
               device_count=len(jax.devices()))
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated bench names (default: all)")
    ap.add_argument("--cpu", action="store_true",
                    help="allow a CPU run at toy sizes (harness check only)")
    ap.add_argument("--child", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.child:
        run_child(args.child, args.cpu)
        return 0

    hooks = {"_hang", "_fail"}
    names = [n for n, _ in BENCHES]
    if args.only:
        keep = set(args.only.split(","))
        unknown = keep - set(names) - hooks
        if unknown:
            sys.stderr.write(f"unknown bench(es): {sorted(unknown)}\n")
            return 2
        names = [n for n in names if n in keep] + [
            h for h in args.only.split(",") if h in hooks]

    # per-child wall-clock cap and a suite-wide deadline: a child that runs
    # past either is killed and counted as failed
    child_timeout = float(os.environ.get("FDTD2D_BENCH_TIMEOUT", "1200"))
    deadline = time.monotonic() + float(
        os.environ.get("FDTD2D_BENCH_SUITE_TIMEOUT", "5400"))
    card_name = card()

    results, failed = [], []
    for name in names:
        left = deadline - time.monotonic()
        if left <= 0:
            sys.stderr.write(f"[bench {name}] suite deadline exceeded; "
                             "not run\n")
            failed.append(name)
            continue
        cmd = [sys.executable, os.path.abspath(__file__), "--child", name]
        try:
            proc = subprocess.run(cmd + (["--cpu"] if args.cpu else []),
                                  capture_output=True, text=True,
                                  timeout=min(child_timeout, left))
        except subprocess.TimeoutExpired:
            sys.stderr.write(f"[bench {name}] timed out after "
                             f"{min(child_timeout, left):.0f} s; killed\n")
            failed.append(name)
            continue
        lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(f"[bench {name}] failed (rc={proc.returncode})\n"
                             f"{proc.stderr[-2000:]}\n")
            failed.append(name)
            continue
        row = json.loads(lines[-1])
        row["card"] = card_name
        results.append(json.dumps(row))
        sys.stderr.write(f"[bench {name}] {results[-1]}\n")
    # all JSON lines on stdout, headline last
    for line in results:
        print(line)
    if failed:
        sys.stderr.write(f"[bench] failed: {failed}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
