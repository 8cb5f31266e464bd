"""Reference workflow 1: FDTD rollout with video export.

Mirrors the reference driver (reference: python-src/fdtd.py:13-40): a 200x200
scene driven by a centered 30 GHz Ricker point source for 1000 steps, 200
snapshot frames rendered to a video. The scene here is drawn with the
geometry rasterizer instead of loading the (absent) example_structure.png.

Run: python examples/fdtd_video.py
"""

import numpy as np

from fdtd2d.core import RegionDrawer, material_init, check_courant
from fdtd2d.fdtd import simulate, FDTDConfig
from fdtd2d.viz import render_video


def main():
    rows = cols = 200
    drawer = RegionDrawer(cols, rows)
    drawer.draw_box((50, 50), 100, 8)
    eps = drawer.to_eps(black_point=10.0)
    _, mu = material_init(None, rows, cols)

    dt, dx = 5e-14, 1e-4
    print(f"courant: {check_courant(eps, mu, dt, dx):.4f}")

    cfg = FDTDConfig(dt=dt, dx=dx, nsteps=1000, source_xy=(rows // 2, cols // 2),
                     source_fc=30e9, nframes=200)
    _, snaps = simulate(eps, mu, cfg)
    out = render_video(np.asarray(snaps), eps, "animation.mp4", fps=15,
                       vmax=1e-3, vmin=-1e-3)
    print(f"wrote {out}")


if __name__ == "__main__":
    from fdtd2d.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    main()
