"""Probe the fast HODLR repeat-solve path at 2048^2.

Target: 2048^2 warm repeat solve to 1e-6 TRUE residual within <= 10 GB of
stored factors. Two levers over the plain compressed configuration (rank
20, q=0, per-sublattice loop solve):
  - stacked sublattice scans (one batched scan instead of 4 sequential),
  - range-finder power iteration (q=1) + rank bump within the byte budget,
    so refinement needs ~2 rounds instead of 8.

Usage: python examples/direct2048_fast_probe.py [N] [rank] [q] [leaf] [stacked]

The STACKED compressed solve program plans ~4x the scan intermediates of
the per-sublattice loop solve (stacked=0 -> DirectSolver(stacked_solve=
False)); which of them fits this card's memory at 2048^2 is not measured
yet (ROADMAP A4). Writes progress to stdout (redirect to a file).
"""

import sys
import time

import numpy as np


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    rank = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    q = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    leaf = int(sys.argv[4]) if len(sys.argv) > 4 else 128
    stacked = bool(int(sys.argv[5])) if len(sys.argv) > 5 else False

    import jax
    print(f"devices: {jax.devices()}", flush=True)

    from fdtd2d.core.scenes import hard_binary_scene
    from fdtd2d.fdfd.direct import DirectSolver

    eps, mu, src = hard_binary_scene(N, seed=3, source_amp=10.0)
    dx, omega = 1e-3, 17e9

    t0 = time.perf_counter()
    solver = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=40,
                          compressed=True, rank=rank, leaf=leaf,
                          power_iters=q, stacked_solve=stacked)
    t1 = time.perf_counter()
    gb = solver.compressed_bytes / 1e9
    print(f"N={N} rank={rank} q={q} leaf={leaf}: factor {t1-t0:.1f} s "
          f"(incl. compile), store {gb:.2f} GB, growth "
          f"{solver.factor_growth:.2e}", flush=True)

    # first solve pays the solve-program compile
    t0 = time.perf_counter()
    _, trace = solver.solve(src, refine_target=1e-6)
    t1 = time.perf_counter()
    print(f"cold solve {t1-t0:.2f} s, trace={['%.2e' % t for t in trace]}",
          flush=True)

    for rep in range(3):
        t0 = time.perf_counter()
        _, trace = solver.solve(src, refine_target=1e-6)
        t1 = time.perf_counter()
        print(f"warm solve {rep}: {t1-t0:.3f} s, rounds={len(trace)-2}, "
              f"trace={['%.2e' % t for t in trace]}", flush=True)

    # tighter target for the accuracy ceiling
    t0 = time.perf_counter()
    _, trace = solver.solve(src, refine_target=1e-9)
    t1 = time.perf_counter()
    print(f"warm solve to 1e-9: {t1-t0:.3f} s, "
          f"trace={['%.2e' % t for t in trace]}", flush=True)


if __name__ == "__main__":
    main()
