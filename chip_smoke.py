#!/usr/bin/env python3
"""Smoke test of the solver stack on one NVIDIA GPU, at real sizes.

Drives the entry points a user calls, in one process, and compares each
with a plain reference; any failed comparison raises, and the process then
exits non-zero without the final line.

    0. device      JAX must find a GPU; prints the card, versions, flags
    1. FDTD        fdtd.simulate: ``auto`` (the K-step CUDA kernel) vs the
                   XLA step at 2048^2 x 1000 steps, vs the float64 NumPy
                   oracle at 512^2 x 500 steps; GCells/s of both backends
                   at 2048^2, 4096^2 and 8192^2
    2. exact FDFD  fdfd.DirectSolver on the hard binary scene at 1024^2
                   (true f64 residual), and vs SciPy spsolve at 512^2
    3. FGMRES      fdfd.solve_fdfd with the FDM preconditioner at 512^2
    4. datagen     models.datagen.generate_batch, 32 scenes at 256^2
    5. training    4 UNet2D train steps at batch 8, 256^2, float32 and
                   bfloat16; one forward loss on the GPU vs the CPU

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--multichip`` runs only the four-card path (a 4-device row mesh for FDTD,
one sublattice per card for the exact solve) and what it is compared with.

Run from the root of a checkout: ``python chip_smoke.py [--multichip]``.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DT, DX, FC = 5e-14, 1e-4, 30e9       # the bench FDTD scene (bench.py)
FDTD_TOL = 1e-5                      # of max|Ez|, tests/test_fdtd_ttiled.py


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: passed in {time.perf_counter() - t0:.1f} s")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"   ok: {what}")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def fdtd_scene(N: int):
    from fdtd2d import constants

    eps = np.full((N, N), constants.EPSILON_0, np.float32)
    eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
    mu = np.full((N, N), constants.MU_0, np.float32)
    return eps, mu


def fdtd_config(N: int, steps: int, backend: str):
    from fdtd2d.fdtd.simulate import FDTDConfig

    return FDTDConfig(dt=DT, dx=DX, nsteps=steps, source_xy=(N // 2, N // 2),
                      source_fc=FC, backend=backend)


def rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# -- phases -------------------------------------------------------------------


def phase_fdtd():
    import jax

    from fdtd2d.fdtd.reference import numpy_simulate
    from fdtd2d.fdtd.simulate import resolve_backend, simulate

    log(f"   auto resolves to {resolve_backend('auto', (2048, 2048))!r}; "
        "float32 fields, float32 arithmetic")
    N, steps = 2048, 1000
    eps, mu = fdtd_scene(N)
    (ea, _, _), _ = simulate(eps, mu, fdtd_config(N, steps, "auto"))
    (ej, _, _), _ = simulate(eps, mu, fdtd_config(N, steps, "jax"))
    err = rel_max(ea, ej)
    log(f"   {N}^2 x {steps}: max|auto - jax| / max|jax| = {err:.3e}")
    check(np.isfinite(np.asarray(ea)).all() and err <= FDTD_TOL,
          f"auto agrees with the XLA step to <= {FDTD_TOL:g} of max|Ez|")

    N, steps = 512, 500
    eps, mu = fdtd_scene(N)
    (ea, _, _), _ = simulate(eps, mu, fdtd_config(N, steps, "auto"))
    ref = numpy_simulate(eps.astype(np.float64), mu.astype(np.float64), DT,
                         DX, steps, (N // 2, N // 2), FC)
    err = rel_max(ea, ref)
    log(f"   {N}^2 x {steps}: max|auto - f64 oracle| / max|oracle| = {err:.3e}")
    check(err <= FDTD_TOL, f"auto agrees with the float64 NumPy oracle to "
          f"<= {FDTD_TOL:g} of max|Ez|")

    for N, steps in ((2048, 2000), (4096, 500), (8192, 120)):
        eps, mu = (jax.device_put(a) for a in fdtd_scene(N))   # off the clock
        rates, fields = {}, {}
        for backend in ("auto", "jax"):
            cfg = fdtd_config(N, steps, backend)
            state, _ = simulate(eps, mu, cfg)            # compile + warm
            fields[backend] = jax.block_until_ready(state)[0]
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                state = jax.block_until_ready(simulate(eps, mu, cfg, state=state)[0])
                best = min(best, time.perf_counter() - t0)
            rates[backend] = N * N * steps / best / 1e9
        err = rel_max(fields["auto"], fields["jax"])
        log(f"   {N}^2 x {steps} steps: auto {rates['auto']:.1f} GCells/s, "
            f"jax {rates['jax']:.1f} GCells/s (best of 3, block_until_ready); "
            f"max|auto - jax| / max|jax| = {err:.3e}")
        check(err <= FDTD_TOL, f"{N}^2 auto agrees with the XLA step")


def phase_direct():
    import jax
    import scipy.sparse.linalg as spla

    from fdtd2d.core.scenes import hard_binary_scene
    from fdtd2d.fdfd.direct import DirectSolver
    from fdtd2d.ops.sparse import make_A_jax

    omega, dx = 17e9, 1e-3
    eps, mu, src = hard_binary_scene(1024, seed=7)
    t0 = time.perf_counter()
    solver = DirectSolver(eps, mu, dx, dx, omega)
    x, trace = solver.solve(src, refine_target=1e-6)
    build = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, trace = solver.solve(src, refine_target=1e-6)
    warm = time.perf_counter() - t0
    log(f"   1024^2 hard binary scene: factor+first solve {build:.1f} s, warm "
        f"solve {warm:.2f} s; true f64 residual per round {trace[:-1]}, of "
        f"the complex64 field {trace[-1]:.2e} (c64 block-LU + f64 refinement)")
    check(trace[-2] <= 1e-6, "refined iterate's true f64 residual <= 1e-6")

    N = 512
    eps, mu, src = hard_binary_scene(N, seed=7)
    x, trace = DirectSolver(eps, mu, dx, dx, omega).solve(src, refine_target=1e-6)
    with jax.default_device(jax.devices("cpu")[0]):
        A = make_A_jax(eps, mu, dx, dx, N, N, omega, 40).to_scipy()
    b = (-1j * omega * src).ravel()
    want = spla.spsolve(A.tocsc(), b).reshape(N, N)
    err = float(np.max(np.abs(np.asarray(x) - want)) / np.max(np.abs(want)))
    log(f"   {N}^2: max|DirectSolver - spsolve| / max|spsolve| = {err:.3e} "
        "(complex64 field vs complex128 sparse LU)")
    check(err <= 1e-5, "DirectSolver agrees with SciPy spsolve to <= 1e-5")


def phase_fgmres():
    import jax.numpy as jnp

    from bench import _fdfd512_scene
    from fdtd2d.fdfd.solver import resolve_preconditioner, solve_fdfd
    from fdtd2d.ops.cplx import to_device_complex
    from fdtd2d.ops.helmholtz import make_operator

    N, dx, omega = 512, 1e-3, 17e9
    eps, mu, src = _fdfd512_scene(N, omega)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=40)
    b = to_device_complex(src, jnp.complex64)
    M, _ = resolve_preconditioner(op, "fdm")
    kw = dict(preconditioner=M, tol=1e-6, maxiter=3000, restart=20)
    solve_fdfd(op, b, **kw)                                # compile
    t0 = time.perf_counter()
    res = solve_fdfd(op, b, **kw)
    rel = float(res.relative_residual)
    log(f"   {N}^2 complex64 FGMRES(20), FDM preconditioner (HIGHEST-precision "
        f"matmuls): {int(res.iterations)} iterations, relative residual "
        f"{rel:.2e}, {time.perf_counter() - t0:.2f} s")
    check(rel < 1e-4, "FGMRES relative residual < 1e-4")


def phase_datagen():
    import jax

    from fdtd2d.models.datagen import generate_batch

    generate_batch(jax.random.PRNGKey(0), batch=32, shape=(256, 256))
    t0 = time.perf_counter()
    out = generate_batch(jax.random.PRNGKey(1), batch=32, shape=(256, 256))
    dt = time.perf_counter() - t0
    worst = float(np.max(out["residuals"]))
    log(f"   32 scenes at 256^2: {32 / dt:.1f} samples/s, worst label true f64 "
        f"residual {worst:.2e}")
    check(np.isfinite(out["Ez"]).all() and worst < 1e-4,
          "datagen labels finite with true residual < 1e-4")


def phase_training():
    import jax
    import jax.numpy as jnp

    from fdtd2d.models.diffusion import DDPMSchedule
    from fdtd2d.models.train import TrainConfig, create_state, train_epoch
    from fdtd2d.models.unet import UNet2D

    B, H, nsteps = 8, 256, 4
    k = jax.random.PRNGKey(1)
    data = {name: jax.random.normal(jax.random.fold_in(k, i),
                                    (B * nsteps, H, H), jnp.float32)
            for i, name in enumerate(("eps", "mu", "src", "Ez"))}
    data["omega"] = jnp.full((B * nsteps,), 2.4, jnp.float32)
    perm = jnp.arange(B * nsteps)
    for dtype in ("float32", "bfloat16"):
        cfg = TrainConfig(batch_size=B, compute_dtype=dtype)
        state = create_state(jax.random.PRNGKey(0), (H, H), cfg)
        schedule = DDPMSchedule.create(cfg.num_train_timesteps)
        t0 = time.perf_counter()
        new, loss = train_epoch(state, schedule, k, data, perm, batch_size=B)
        loss = float(jax.block_until_ready(loss))
        moved = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(
            jax.tree.leaves(new.params), jax.tree.leaves(state.params)))
        log(f"   UNet2D {dtype}: {nsteps} steps at batch {B}, {H}^2 "
            f"(compile included {time.perf_counter() - t0:.1f} s): mean loss "
            f"{loss:.4f}, largest parameter change {moved:.2e}")
        check(np.isfinite(loss) and moved > 0, f"{dtype} loss finite and "
              "parameters updated")

    model = UNet2D()
    key = jax.random.PRNGKey(2)
    f = [jax.random.normal(jax.random.fold_in(key, i), (2, 64, 64), jnp.float32)
         for i in range(5)]
    t = jnp.asarray([10, 500], jnp.int32)
    om = jnp.asarray([2.4, 1.9], jnp.float32)
    variables = model.init(key, *f[:4], t, om)

    def loss_fn(variables, eps, mu, src, noisy, target, t, om):
        out = model.apply(variables, eps, mu, src, noisy, t, om)
        return jnp.mean((out - target) ** 2)

    args = (variables, *f, t, om)
    gpu = float(jax.jit(loss_fn)(*args))
    cpu = float(jax.jit(loss_fn)(*jax.device_put(args, jax.devices("cpu")[0])))
    rel = abs(gpu - cpu) / abs(cpu)
    log(f"   forward loss batch 2, 64^2: GPU {gpu:.6f} vs CPU {cpu:.6f}, "
        f"relative difference {rel:.2e} (float32 convolutions run in TF32 "
        "on the GPU)")
    check(rel <= 2e-2, "GPU forward loss agrees with the CPU to 2e-2")


def phase_multichip():
    import jax
    import jax.numpy as jnp

    from fdtd2d.core.scenes import hard_binary_scene
    from fdtd2d.fdfd.direct import DirectSolver
    from fdtd2d.fdfd.refine import refine
    from fdtd2d.fdtd.simulate import simulate
    from fdtd2d.ops.helmholtz import make_operator
    from fdtd2d.ops.splitc import split_from_numpy
    from fdtd2d.parallel import (
        factor_sharded, make_mesh, simulate_sharded, solve_factored_sharded)

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--multichip needs 4 GPUs, found {len(devices)}")
    mesh = make_mesh((4,), axis_names=("x",), devices=devices[:4])

    N, steps = 4096, 1000
    eps, mu = (jax.device_put(a) for a in fdtd_scene(N))
    cfg = fdtd_config(N, steps, "auto")
    (want, _, _), _ = simulate(eps, mu, cfg)
    (got, _, _), _ = simulate_sharded(eps, mu, cfg, mesh)
    err = rel_max(got, want)
    rates = {}
    for name, run in (("1 card", lambda: simulate(eps, mu, cfg)),
                      ("4 cards", lambda: simulate_sharded(eps, mu, cfg, mesh))):
        t0 = time.perf_counter()
        jax.block_until_ready(run()[0])
        rates[name] = N * N * steps / (time.perf_counter() - t0) / 1e9
    log(f"   FDTD {N}^2 x {steps}, 4-device row mesh (K-step kernel per card, "
        f"ppermute ghost rows): max|sharded - single| / max|single| = "
        f"{err:.3e}; {rates['4 cards']:.1f} GCells/s on 4 cards vs "
        f"{rates['1 card']:.1f} on 1 (warm, one run each)")
    check(err <= FDTD_TOL, f"sharded FDTD agrees with one device to <= {FDTD_TOL:g}")

    omega, dx = 17e9, 1e-3
    eps, mu, src = hard_binary_scene(1024, seed=7)
    solver = DirectSolver(eps, mu, dx, dx, omega)
    want, wtrace = solver.solve(src, refine_target=1e-10, return_split=True)
    op = make_operator(eps, mu, dx, dx, omega, 40)
    f = factor_sharded(op, make_mesh((4,), axis_names=("s",),
                                     devices=devices[:4]))
    b64 = split_from_numpy(np.asarray(src, np.complex128) * (-1j * omega))
    out = refine(solver.op64, b64, lambda r: solve_factored_sharded(f, r),
                 target=1e-10)
    to_c = lambda s: np.asarray(s.re) + 1j * np.asarray(s.im)
    a, b = to_c(out.x), to_c(want)
    err = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    log(f"   exact FDFD 1024^2, one sublattice per card: true f64 residual "
        f"sharded {float(out.relative_residual):.2e}, single {wtrace[-1]:.2e}; "
        f"max|sharded - single| / max|single| = {err:.3e} (f64 iterates)")
    check(err <= 1e-6, "sharded exact solve agrees with DirectSolver to <= 1e-6")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card path")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    try:
        import fdtd2d  # noqa: F401
    except ImportError:
        sys.stderr.write("chip_smoke.py runs from the root of a checkout "
                         "(the fdtd2d package was not found beside it)\n")
        return 2
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.stderr.write(f"no GPU found (platform {devices[0].platform!r})\n")
        return 1

    from fdtd2d.utils.cache import enable_compilation_cache

    with phase("0 device"):
        import jaxlib

        log(f"   {len(devices)} x {devices[0].device_kind}; nvidia-smi: {card()}")
        log(f"   jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
            f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, compile cache "
            f"{enable_compilation_cache()}")

    phases = ([("multichip", phase_multichip)] if args.multichip else
              [("1 FDTD", phase_fdtd), ("2 exact FDFD", phase_direct),
               ("3 FGMRES", phase_fgmres), ("4 datagen", phase_datagen),
               ("5 training", phase_training)])
    for name, fn in phases:
        with phase(name):
            fn()

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
