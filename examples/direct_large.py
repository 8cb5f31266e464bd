"""Past-the-memory-wall exact solve on one chip: segment-checkpointed
sublattice block-Thomas factorization at 2048^2 (or given N) on the HARD
50%-duty binary 5x-contrast scene — the regime where the reference's
spsolve LU dies of fill-in (README.md:135 reports ~20 s already at 1000^2)
and the two-level ORAS tiled solver stalls at ~0.3 relative residual.

Store-all-W factors need 4*(N/2)^3*8 B (34 GB at 2048^2 — impossible on one
chip). Two past-the-wall modes:

- checkpointed (default): stores W every `stride` rows (~1 GB total at
  2048^2) and re-runs the inversion recursion twice per solve, trading
  compute for the W-storage wall.
- compressed: stores every W in fixed-rank HODLR form (fdfd/compressed.py,
  ~9 GB at 2048^2 with rank 20/leaf 128); repeat solves stay two batched-
  matmul scans — no recursion re-runs — and f64 refinement restores the
  exact residual.
- hps: HPS nested-dissection factorization (fdfd/hps.py) — O(N^2 log N)
  stored factors and LOG-DEPTH batched-matmul solves instead of the
  block-Thomas modes' N/2 sequential scan steps. Accuracy boundary:
  c64 interface conditioning caps this mode at <=1024^2 on hard scenes
  (measured — see fdfd/hps.py); at 2048^2+ use checkpointed/compressed.

Usage: python examples/direct_large.py [N] [stride]
       [checkpointed|compressed|hps]
"""
import sys
import time

import numpy as np

from fdtd2d.utils.cache import enable_compilation_cache

enable_compilation_cache()

from fdtd2d import constants  # noqa: E402
from fdtd2d.fdfd.direct import DirectSolver  # noqa: E402


def hard_scene(N, seed=7):
    from fdtd2d.core.scenes import hard_binary_scene

    return hard_binary_scene(N, seed=seed, source_xy=(N // 3, N // 3))


def main(N=2048, stride=64, mode="checkpointed"):
    omega, dx = 17e9, 1e-3
    eps, mu, src = hard_scene(N)
    store_all = 4 * (N // 2) ** 3 * 8 / 1e9
    if mode == "checkpointed":
        print(f"N={N} stride={stride}: checkpoint memory "
              f"~{4 * (N // 2 // stride + 1) * (N // 2) ** 2 * 8 / 1e9:.2f} "
              f"GB (store-all would be {store_all:.1f} GB)")
        kwargs = dict(checkpointed=True, stride=stride)
    elif mode == "compressed":
        print(f"N={N}: HODLR-compressed W store "
              f"(store-all would be {store_all:.1f} GB)")
        kwargs = dict(compressed=True)
    elif mode == "hps":
        print(f"N={N}: HPS nested-dissection factors "
              f"(store-all would be {store_all:.1f} GB)")
        kwargs = dict(hps=True)
    else:
        raise SystemExit(f"unknown mode {mode!r}")

    t0 = time.perf_counter()
    solver = DirectSolver(eps, mu, dx, dx, omega, **kwargs)
    t_build = time.perf_counter() - t0
    if mode == "compressed":
        print(f"compressed store: {solver.compressed_bytes / 1e9:.2f} GB "
              f"({store_all / (solver.compressed_bytes / 1e9):.1f}x smaller)")
    elif mode == "hps":
        print(f"HPS factor store: {solver.hps_bytes / 1e9:.2f} GB "
              f"({store_all / (solver.hps_bytes / 1e9):.1f}x smaller)")

    t0 = time.perf_counter()
    x, trace = solver.solve(src, refine_target=1e-8, verbose=True)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, trace = solver.solve(src, refine_target=1e-8, verbose=True)
    t_warm = time.perf_counter() - t0
    print(f"build(+factor dispatch) {t_build:.1f} s; first solve "
          f"{t_first:.1f} s; warm solve {t_warm:.1f} s; final TRUE residual "
          f"{trace[-1]:.3e}")

    # amortized sweep cost: ONE factorization, B sources, joint refinement
    # (the interactive-sweep regime). The RHS axis widens the backsolve
    # matmuls' free dimension, idle at B=1, so per-source cost drops well
    # below t_warm.
    B = 8
    rng = np.random.default_rng(11)
    srcs = np.zeros((B, N, N), np.complex64)
    srcs[0] = src
    for i in range(1, B):
        r, c = rng.integers(N // 4, 3 * N // 4, 2)
        srcs[i, r, c] = 10.0
    xb, per_sample, btrace = solver.solve_batched(srcs, refine_target=1e-8)
    t0 = time.perf_counter()
    xb, per_sample, btrace = solver.solve_batched(srcs, refine_target=1e-8)
    t_batch = time.perf_counter() - t0
    print(f"warm batched sweep: {B} sources in {t_batch:.1f} s "
          f"({t_batch / B:.2f} s/source, {t_warm / (t_batch / B):.1f}x "
          f"over per-source warm solves); worst TRUE residual "
          f"{float(np.max(np.asarray(per_sample))):.3e}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2048,
         int(sys.argv[2]) if len(sys.argv) > 2 else 64,
         sys.argv[3] if len(sys.argv) > 3 else "checkpointed")
