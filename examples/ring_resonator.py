"""Reference workflow 2: steady-state FDFD of a ring resonator.

Mirrors the reference's headline FDFD plot (reference: README.md:95-97 and
python-src/fdfd.py:81-118): a waveguide coupled to a ring resonator, excited
at a fixed frequency, solved in the frequency domain and rendered.

Run: python examples/ring_resonator.py
"""

import numpy as np
import jax.numpy as jnp

from fdtd2d import constants
from fdtd2d.core import RegionDrawer, check_resolution
from fdtd2d.fdfd import run_fdfd
from fdtd2d.viz import plot_Ez


def main():
    N, dx, omega = 512, 1e-3, 17e9

    drawer = RegionDrawer(N, N)
    drawer.draw_waveguide((60, 160), (N - 60, 160), 10)          # bus waveguide
    drawer.draw_ring_resonator((N // 2, 280), 90, 10)            # ring below it
    eps = drawer.to_eps(black_point=3.0)
    mu = np.full((N, N), constants.MU_0)
    check_resolution(eps, mu, omega, dx)

    source = np.zeros((N, N), np.float32)
    source[150:170, 80] = 10.0   # line source feeding the bus guide

    res = run_fdfd(eps, mu, dx, dx, omega, source,
                   rhs_scale=omega,  # reference driver convention (fdfd.py:112)
                   tol=1e-5, maxiter=600)
    print(f"relative residual: {float(res.relative_residual):.2e}")

    Ez = np.asarray(jnp.real(res.x))
    m = float(np.abs(Ez).max())
    plot_Ez(Ez, eps, "ring_resonator_Ez.png", vmax=m, vmin=-m)
    print("wrote ring_resonator_Ez.png")


if __name__ == "__main__":
    from fdtd2d.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    main()
