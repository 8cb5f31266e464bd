"""Visualization + CLI smoke tests."""

import os

import numpy as np
import jax.numpy as jnp

from fdtd2d import constants
from fdtd2d.viz.render import field_to_rgb, capture_snapshot, save_frames, render_video
from fdtd2d.viz.plots import (
    plot_sparsity, plot_convergence, plot_ref_v_inference, plot_noisy_sample,
    plot_frequency_response,
)


def _scene(N=32):
    eps = np.full((N, N), constants.EPSILON_0)
    eps[10:20, 10:20] *= 4
    return eps


def test_field_to_rgb_batched(tmp_path):
    eps = _scene()
    Ez = np.sin(np.linspace(0, 6, 32))[:, None] * np.ones((32, 32))
    rgb = field_to_rgb(Ez, eps, vmax=1, vmin=-1)
    assert rgb.shape == (32, 32, 3) and rgb.dtype == np.uint8

    stack = np.stack([Ez, -Ez, 0 * Ez])
    rgbs = field_to_rgb(stack, eps, vmax=1, vmin=-1)
    assert rgbs.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(rgbs[0], rgb)

    p = tmp_path / "snap.png"
    capture_snapshot(Ez, eps, str(p), vmax=1, vmin=-1)
    assert p.exists() and p.stat().st_size > 0


def test_render_video_gif_fallback(tmp_path):
    eps = _scene()
    snaps = np.stack([np.roll(np.eye(32), k, axis=1) for k in range(5)])
    out = render_video(snaps, eps, str(tmp_path / "anim.mp4"),
                       workdir=str(tmp_path / "frames"))
    assert os.path.exists(out) and os.path.getsize(out) > 0
    assert len(os.listdir(tmp_path / "frames")) == 5


def test_plots_write_files(tmp_path):
    from fdtd2d.ops.sparse import make_A_jax

    A = make_A_jax(jnp.ones((12, 12)), jnp.ones((12, 12)), 1.0, 1.0, 12, 12,
                   1.0, pml_thickness=3)
    plot_sparsity(A, str(tmp_path / "sp.png"))
    plot_convergence({"schwarz": [1.0, 0.1, 0.01]}, str(tmp_path / "conv.png"))
    plot_ref_v_inference(np.ones((8, 8)), np.zeros((8, 8)), str(tmp_path / "cmp.png"))
    plot_noisy_sample(np.zeros((3, 8, 8)), str(tmp_path / "noisy.png"))
    plot_frequency_response([1, 2, 3], [1.0, 0.5, 0.1], [1, 0, 0],
                            str(tmp_path / "fr.png"))
    from fdtd2d.fdfd.tiled import generate_patches, bfs_order
    from fdtd2d.viz.plots import plot_patch_distances

    src = np.zeros((160, 160)); src[80, 80] = 1.0
    origins = generate_patches(160, 160, 64, 16)
    dists = bfs_order(origins, 96, src, halo=8)
    plot_patch_distances(origins, dists, 96, (160, 160),
                         str(tmp_path / "pd.png"), source=src)
    for f in ("sp.png", "conv.png", "cmp.png", "noisy.png", "fr.png", "pd.png"):
        assert (tmp_path / f).stat().st_size > 0


def test_cli_fdtd_and_fdfd(tmp_path, monkeypatch, capsys):
    from fdtd2d.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["fdtd", "--size", "64", "--steps", "40", "--frames", "4",
                 "--backend", "jax", "--video", "out.mp4"]) == 0
    out = capsys.readouterr().out
    assert "courant" in out and "max |Ez|" in out
    assert os.path.exists("out.gif") or os.path.exists("out.mp4")

    assert main(["fdfd", "--size", "96", "--omega", "17e9", "--maxiter", "100",
                 "--out", "ez.png"]) == 0
    out = capsys.readouterr().out
    assert "relative residual" in out
    assert os.path.getsize("ez.png") > 0


def test_cli_tiled_plot_patches(tmp_path, monkeypatch, capsys):
    from fdtd2d.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["tiled", "--size", "160", "--omega", "17e9",
                 "--patch-size", "64", "--padding", "24",
                 "--mode", "additive", "--out", "ez_tiled.png",
                 "--plot-patches", "patches.png"]) == 0
    assert os.path.getsize("patches.png") > 0
    assert os.path.getsize("ez_tiled.png") > 0


def test_scene_container():
    from fdtd2d.core.grid import Scene
    from fdtd2d import constants

    s = Scene.vacuum(32, 48, dx=1e-3)
    assert s.shape == (32, 48) and s.dx == 1e-3
    src = s.point_source(4, 7, amp=2.0)
    assert float(src[4, 7]) == 2.0 and float(src.sum()) == 2.0
    v = Scene.from_image(None, 16, 16, dx=1e-4)
    assert np.allclose(np.asarray(v.eps), constants.EPSILON_0)


def test_cli_invdes(tmp_path, monkeypatch, capsys):
    from fdtd2d.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["invdes", "--size", "50", "--steps", "2", "--freqs", "2",
                 "--out", "fr.png"]) == 0
    assert "final loss" in capsys.readouterr().out
    assert os.path.getsize("fr.png") > 0
