"""Reference workflow 3: tiled (domain-decomposed) vs direct solve comparison.

Mirrors the reference's tiled-solver validation (reference: README.md:131-134
and python-src/tiled_solver.py): solve the same scene with the global solver
and with the tiled Schwarz machinery, and render both fields plus the error.

Run: python examples/tiled_vs_direct.py
"""

import numpy as np
import jax.numpy as jnp

from fdtd2d import constants
from fdtd2d.fdfd import run_fdfd
from fdtd2d.fdfd.tiled import run_fdfd_tiled
from fdtd2d.viz import plot_Ez
from fdtd2d.viz.plots import plot_ref_v_inference


def main():
    N, dx, omega = 512, 1e-3, 17e9
    eps = np.full((N, N), constants.EPSILON_0)
    eps[180:330, 140:240] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    source = np.zeros((N, N), np.float32)
    source[N // 2, N // 2] = 10.0

    direct = run_fdfd(eps, mu, dx, dx, omega, source, tol=1e-6, maxiter=600)
    print(f"global solve residual: {float(direct.relative_residual):.2e}")

    # krylov mode: two-level ORAS+PoU preconditioner + f64 iterative
    # refinement — converges to ~1e-9 TRUE residual in complex64 (a
    # one-level RAS stalls at ~0.7 here). The stationary
    # modes reproduce the reference's approximate behavior.
    tiled, trace = run_fdfd_tiled(eps, mu, dx, dx, omega, source,
                                  patch_size=100, padding=30, mode="krylov",
                                  solver_maxiter=240, refine_target=1e-8)
    print(f"tiled (krylov) iterate true residual: {trace[-2]:.2e}; "
          f"returned-field (c64 downcast) residual: {trace[-1]:.2e}")

    a = np.asarray(jnp.real(direct.x))
    b = np.asarray(jnp.real(tiled))
    err = np.abs(a - b).max() / np.abs(a).max()
    print(f"tiled vs direct relative field error: {err:.2e}")
    plot_ref_v_inference(a, b, "tiled_vs_direct.png")
    print("wrote tiled_vs_direct.png")


if __name__ == "__main__":
    from fdtd2d.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    main()
