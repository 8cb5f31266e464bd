"""CLI datagen -> train pipeline smoke (tiny, CPU) + RHS convention parity."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from fdtd2d import constants


@pytest.mark.slow
def test_cli_datagen_train_roundtrip(tmp_path, monkeypatch, capsys):
    from fdtd2d.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["datagen", "--samples", "6", "--size", "48", "--batch", "6",
                 "--pml", "8", "--out", "d.npz"]) == 0
    out = capsys.readouterr().out
    assert "worst solve residual" in out
    raw = np.load("d.npz")
    assert raw["Ez"].shape == (6, 48, 48)

    assert main(["train", "--data", "d.npz", "--epochs", "1", "--batch", "2",
                 "--ckpt-dir", "ck", "--eval-every", "1", "--eval-dir", "ev",
                 "--holdout", "2"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out
    assert "holdout rel-L2" in out
    assert any(d.startswith("epoch_") for d in os.listdir("ck"))
    # the reference's noise-schedule grid + eval panel + holdout metrics all
    # land in the eval dir
    assert os.path.exists("ev/noise_schedule.png")
    assert os.path.exists("ev/holdout_metrics.csv")
    assert any(d.startswith("eval_epoch_") for d in os.listdir("ev"))


def test_rhs_conventions_are_linear_rescalings():
    """The reference drivers use three RHS conventions (omega, +i*omega,
    -i*omega — SURVEY.md C3); solutions must be exact complex rescalings."""
    from fdtd2d.fdfd.solver import run_fdfd

    N = 48
    rng = np.random.default_rng(2)
    eps = constants.EPSILON_0 * (1 + rng.random((N, N)))
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N)); src[24, 24] = 1.0
    omega = 17e9
    kw = dict(pml_thickness=8, dtype=jnp.complex128, tol=1e-10, maxiter=400)

    x_default = np.asarray(run_fdfd(eps, mu, 1e-3, 1e-3, omega, src, **kw).x)
    x_plain = np.asarray(run_fdfd(eps, mu, 1e-3, 1e-3, omega, src,
                                  rhs_scale=omega, **kw).x)
    x_plus = np.asarray(run_fdfd(eps, mu, 1e-3, 1e-3, omega, src,
                                 rhs_scale=1j * omega, **kw).x)
    scale = np.abs(x_plain).max()
    # default is -1j*omega: x_default == -1j * x_plain == -x_plus
    assert np.abs(x_default - (-1j) * x_plain).max() / scale < 1e-6
    assert np.abs(x_default + x_plus).max() / scale < 1e-6
