"""Diagnostic plots: sparsity, convergence, prediction panels.

Equivalents of the reference's plot_nonzero (python-src/fdfd.py:64-78),
plot_noisy_sample / plot_ref_v_inference
(python-src/diffusion_training.py:215-235, 255-280), plus convergence and
frequency-response plots for the solver/inverse-design workloads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_sparsity(A, path: str = "matrix_pattern.png", max_dim: int = 5000) -> None:
    """Nonzero pattern of the leading block of a CSR matrix."""
    plt = _plt()
    from fdtd2d.ops.sparse import CSR

    dense = (A.to_scipy() if isinstance(A, CSR) else A)[
        :max_dim, :max_dim].toarray()
    plt.figure(figsize=(10, 10))
    plt.imshow(dense != 0, cmap="RdBu")
    plt.title(f"Sparsity pattern (first {dense.shape[0]}x{dense.shape[1]})")
    plt.xlabel("Column index")
    plt.ylabel("Row index")
    plt.savefig(path, dpi=200, bbox_inches="tight")
    plt.close()


def plot_convergence(traces: dict, path: str = "convergence.png",
                     ylabel: str = "residual / max delta") -> None:
    """Per-sweep/iteration convergence telemetry (the reference only prints,
    tiled_solver.py:220)."""
    plt = _plt()
    plt.figure(figsize=(7, 5))
    for label, ys in traces.items():
        plt.semilogy(np.arange(1, len(ys) + 1), ys, marker="o", label=label)
    plt.xlabel("sweep / iteration")
    plt.ylabel(ylabel)
    plt.grid(True, which="both", alpha=0.3)
    plt.legend()
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()


def plot_ref_v_inference(ref, pred, path: str) -> None:
    """Side-by-side true vs predicted field panels."""
    plt = _plt()
    ref = np.asarray(ref)
    pred = np.asarray(pred)
    m = max(np.abs(ref).max(), np.abs(pred).max()) or 1.0
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    im1 = ax1.imshow(pred, cmap="seismic", vmin=-m, vmax=m)
    ax1.set_title("Predicted Ez")
    im2 = ax2.imshow(ref, cmap="seismic", vmin=-m, vmax=m)
    ax2.set_title("True Ez")
    fig.colorbar(im1, ax=ax1)
    fig.colorbar(im2, ax=ax2)
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_noisy_sample(frames, path: str = "noise_schedule.png") -> None:
    """Grid of one sample across diffusion timesteps (T, H, W)."""
    plt = _plt()
    frames = np.asarray(frames)
    T = frames.shape[0]
    fig, axes = plt.subplots(1, T, figsize=(2 * T, 2.4))
    if T == 1:
        axes = [axes]
    for t, ax in enumerate(axes):
        ax.imshow(frames[t], cmap="bwr", vmin=-0.5, vmax=0.5)
        ax.set_title(f"t={t}")
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close(fig)


def plot_patch_distances(origins, dists, W: int, shape,
                         path: str = "patch_distances.png",
                         source=None) -> None:
    """BFS source-distance map of the tiled solver's patches.

    Equivalent of the reference's patch-distance diagnostic
    (reference README.md assets/patch_distances.png, data from
    python-src/tiled_solver.py:159-185): each patch window is painted with
    its BFS distance from the source-containing patches (nearer patches win
    where windows overlap), with the window outlines drawn on top.
    """
    plt = _plt()
    origins = np.asarray(origins)
    dists = np.asarray(dists)
    Nx, Ny = shape
    field = np.full((Nx, Ny), np.nan)
    for p in np.argsort(dists)[::-1]:  # paint far first; near overwrites
        x0, y0 = origins[p]
        field[x0 : x0 + W, y0 : y0 + W] = dists[p]
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(field, cmap="viridis")
    for (x0, y0), d in zip(origins, dists):
        ax.add_patch(plt.Rectangle((y0, x0), W, W, fill=False,
                                   edgecolor="white", linewidth=0.5, alpha=0.6))
        ax.text(y0 + W / 2, x0 + W / 2, str(int(d)), color="white",
                ha="center", va="center", fontsize=7)
    if source is not None:
        sx, sy = np.nonzero(np.asarray(source))
        ax.plot(sy, sx, "r*", markersize=10)
    ax.set_title("Patch BFS distance from source")
    fig.colorbar(im, ax=ax, label="sweep order distance")
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_frequency_response(omegas, measured, ideal=None,
                            path: str = "frequency_response.png") -> None:
    """Measured vs ideal normalized response (inverse-design workload)."""
    plt = _plt()
    measured = np.asarray(measured, np.float64)
    plt.figure(figsize=(8, 5))
    plt.plot(np.asarray(omegas), measured / measured.max(), "o-", label="Measured")
    if ideal is not None:
        plt.plot(np.asarray(omegas), np.asarray(ideal), "x--", label="Ideal")
    plt.xlabel("Frequency (Hz)")
    plt.ylabel("Normalized response")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()


def plot_training_curves(losses: Sequence[float],
                         holdout_epochs: Optional[Sequence[int]] = None,
                         holdout_rel_l2: Optional[Sequence[float]] = None,
                         path: str = "training_curves.png") -> None:
    """Loss curve (+ optional holdout relative-L2 on a twin axis) for a
    surrogate training run — the quantitative record the reference's
    per-epoch eyeball panels lack."""
    plt = _plt()
    fig, ax1 = plt.subplots(figsize=(8, 5))
    ax1.plot(np.arange(len(losses)), np.asarray(losses), color="tab:blue",
             label="train loss (SNR-weighted MSE)")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("train loss", color="tab:blue")
    ax1.set_yscale("log")
    if holdout_epochs is not None and holdout_rel_l2 is not None:
        ax2 = ax1.twinx()
        ax2.plot(np.asarray(holdout_epochs), np.asarray(holdout_rel_l2),
                 color="tab:red", marker="o",
                 label="holdout rel-L2 (mean)")
        ax2.set_ylabel("holdout relative L2", color="tab:red")
        ax2.set_yscale("log")
    fig.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close(fig)
