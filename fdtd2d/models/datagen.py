"""On-device surrogate training data generation (vmapped, no host loop).

Reference semantics (python-src/diffusion_training.py:36-193): per sample a
random binary permittivity field (Gaussian-blurred uniform noise thresholded
at 0.5 -> eps0 or 5*eps0, kernel 15, sigma ~ U[2,6]), a random line-or-point
source in the middle 80% of the grid, omega ~ U[18,30] GHz, and the label is
the real part of the FDFD solve with b = -1j*omega*src. The reference loops
one scipy ``spsolve`` per sample on the host; here the whole batch is one
``vmap`` of the matrix-free preconditioned Krylov solve on device.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fdtd2d import constants
from fdtd2d.ops.helmholtz import HelmholtzOperator, pml_sigma_profile
from fdtd2d.ops.fdm import fdm_preconditioner
from fdtd2d.ops.krylov import fgmres

KERNEL_SIZE = 15
EPS_LO = constants.EPSILON_0_DATAGEN
EPS_HI = 5.0 * constants.EPSILON_0_DATAGEN
MU_REF = constants.MU_0_DATAGEN


def random_permittivity(key, shape: Tuple[int, int]):
    """Blur-threshold binary permittivity (reference :54-93)."""
    k_noise, k_sigma = jax.random.split(key)
    noise = jax.random.uniform(k_noise, shape)
    sigma = jax.random.uniform(k_sigma, ()) * 4.0 + 2.0
    coords = jnp.arange(KERNEL_SIZE) - KERNEL_SIZE // 2
    xg, yg = jnp.meshgrid(coords, coords, indexing="ij")
    kern = jnp.exp(-(xg**2 + yg**2) / (2.0 * sigma**2))
    kern = kern / jnp.sum(kern)
    blurred = jax.scipy.signal.convolve2d(noise, kern, mode="same")
    eps = jnp.where(blurred > 0.5, EPS_HI, EPS_LO)
    mu = jnp.full(shape, MU_REF)
    return eps, mu


def random_source(key, shape: Tuple[int, int]):
    """Random line (<=10% span) or point source in the middle 80%
    (reference :96-146)."""
    H, W = shape
    sx0, sx1 = max(5, H // 10), min(H - 5, H - H // 10)
    sy0, sy1 = max(5, W // 10), min(W - 5, W - W // 10)
    L = max((min(sx1 - sx0, sy1 - sy0)) // 10, 1)

    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    is_line = jax.random.uniform(k1, ()) < 0.5
    is_horiz = jax.random.uniform(k2, ()) < 0.5
    r = jax.random.randint(k3, (), sx0, sx1)
    c = jax.random.randint(k4, (), sy0, sy1)
    # line starts are drawn independently and uniformly over the valid range
    # (reference :109-146 draws them separately from the fixed coordinate;
    # clipping the point coordinate instead would pile probability mass at
    # the interval ends and skew the training distribution)
    c_start = jax.random.randint(k5, (), sy0, max(sy1 - L, sy0 + 1))
    r_start = jax.random.randint(k6, (), sx0, max(sx1 - L, sx0 + 1))

    rows = jnp.arange(H)[:, None]
    cols = jnp.arange(W)[None, :]
    horiz_line = (rows == r) & (cols >= c_start) & (cols < c_start + L)
    vert_line = (cols == c) & (rows >= r_start) & (rows < r_start + L)
    point = (rows == r) & (cols == c)
    mask = jnp.where(is_line, jnp.where(is_horiz, horiz_line, vert_line), point)
    return mask.astype(jnp.float32)


def random_omega(key):
    """omega ~ U[18, 30] GHz (reference :177; its comment says 9-30 but the
    code draws 18e9..30e9)."""
    return jax.random.uniform(key, ()) * (30e9 - 18e9) + 18e9


def make_operator_traced(eps, mu, dx, dy, omega, pml_thickness: int,
                         sigma_max: float = 2.0, m: int = 3,
                         dtype=jnp.complex64) -> HelmholtzOperator:
    """Operator with a *traced* omega (vmappable over frequency batches).

    Same semantics as fdtd2d.ops.helmholtz.make_operator, but the PML
    stretch factors are computed in jnp from the (static) sigma profiles.
    """
    Nx, Ny = eps.shape
    sig_r = jnp.asarray(pml_sigma_profile(Nx, pml_thickness, sigma_max, m))
    sig_c = jnp.asarray(pml_sigma_profile(Ny, pml_thickness, sigma_max, m))
    s_r = 1.0 + 1j * sig_r / (omega * constants.EPSILON_0)
    s_c = 1.0 + 1j * sig_c / (omega * constants.EPSILON_0)
    real = jnp.finfo(dtype).dtype
    return HelmholtzOperator(
        eps=jnp.asarray(eps, real), inv_mu=(1.0 / jnp.asarray(mu)).astype(real),
        inv_s_row=(1.0 / s_r).astype(dtype), inv_s_col=(1.0 / s_c).astype(dtype),
        omega=jnp.asarray(omega, real),
        inv_2dx=jnp.asarray(1.0 / (2.0 * dx), real),
        inv_2dy=jnp.asarray(1.0 / (2.0 * dy), real),
        pml_thickness=pml_thickness, sigma_max=sigma_max, m=m,
    )


@partial(jax.jit, static_argnames=("shape", "batch", "pml_thickness", "maxiter", "dx"))
def generate_batch_krylov(key, *, batch: int, shape: Tuple[int, int],
                          dx: float = 1e-3, pml_thickness: int = 40,
                          maxiter: int = 400, M=None):
    """Krylov-labeled batch (the round-1/2 path, kept for comparison).

    The reference's datagen scenes (50% duty binary 5x contrast at 18-30 GHz
    on dx=1mm) are among the hardest indefinite Helmholtz problems: the
    shared mid-band FDM-FGMRES stalls at ~1e-2 relative residual on ~90% of
    samples (measured at 256^2) — use :func:`generate_batch` (exact direct
    labels) for training data.
    """
    keys = jax.random.split(key, batch)

    def one(k):
        k_eps, k_src, k_om = jax.random.split(k, 3)
        eps, mu = random_permittivity(k_eps, shape)
        src = random_source(k_src, shape)
        omega = random_omega(k_om)
        op = make_operator_traced(eps, mu, dx, dx, omega, pml_thickness)
        b = (jnp.asarray(-1j, jnp.complex64) * omega.astype(jnp.complex64)
             * src.astype(jnp.complex64))
        out = fgmres(op.apply, b, M, restart=40, maxiter=maxiter, tol=1e-4)
        Ez = jnp.real(out.x).astype(jnp.float32)
        return eps.astype(jnp.float32), mu.astype(jnp.float32), src, \
            omega.astype(jnp.float32), Ez, out.relative_residual

    eps, mu, src, omega, Ez, res = jax.vmap(one)(keys)
    return dict(eps=eps, mu=mu, src=src, omega=omega, Ez=Ez, residuals=res)


def _five_point_residual_host(eps, mu, src, omega, Ez_c, dx: float,
                              pml_thickness: int) -> np.ndarray:
    """Per-sample TRUE float64 relative residuals, evaluated host-side with
    the numpy pentadiagonal form of the operator (vectorized over the
    batch; ~1e7 flops — negligible next to the solves)."""
    from fdtd2d.ops.helmholtz import stretch_factors

    B, Nx, Ny = eps.shape
    im = 1.0 / np.asarray(mu, np.float64)
    x = np.asarray(Ez_c, np.complex128)
    res = np.empty(B)
    for i in range(B):
        s_r, s_c = stretch_factors(Nx, Ny, float(omega[i]), pml_thickness,
                                   2.0, 3)
        isr = (1.0 / s_r)[:, None]
        isc = (1.0 / s_c)[None, :]
        a = 1.0 / (2.0 * dx)

        def dcol(f):
            out = np.zeros_like(f)
            out[:, :-1] += f[:, 1:]
            out[:, 1:] -= f[:, :-1]
            return out * a

        def drow(f):
            out = np.zeros_like(f)
            out[:-1, :] += f[1:, :]
            out[1:, :] -= f[:-1, :]
            return out * a

        xi = x[i]
        tc = dcol(dcol(xi * isc) * im[i]) * isc
        tr = drow(drow(xi * isr) * im[i]) * isr
        ax = -(tc + tr) - (float(omega[i]) ** 2) * np.asarray(eps[i], np.float64) * xi
        b = -1j * float(omega[i]) * np.asarray(src[i], np.float64)
        res[i] = np.linalg.norm(ax - b) / np.linalg.norm(b)
    return res


@partial(jax.jit, static_argnames=("shape", "batch", "pml_thickness", "dx"))
def _generate_batch_direct_device(key, *, batch: int, shape: Tuple[int, int],
                                  dx: float, pml_thickness: int):
    from fdtd2d.fdfd.direct import factor, solve_factored

    keys = jax.random.split(key, batch)

    def one(k):
        k_eps, k_src, k_om = jax.random.split(k, 3)
        eps, mu = random_permittivity(k_eps, shape)
        src = random_source(k_src, shape)
        omega = random_omega(k_om)
        op = make_operator_traced(eps, mu, dx, dx, omega, pml_thickness)
        b = (jnp.asarray(-1j, jnp.complex64) * omega.astype(jnp.complex64)
             * src.astype(jnp.complex64))
        f = factor(op)
        x = solve_factored(f, b)
        # one complex64 refinement round: the no-pivoting block-LU loses a
        # few digits; re-solving the residual restores the c64 floor (~1e-6)
        x = x + solve_factored(f, b - op.apply(x))
        return eps.astype(jnp.float32), mu.astype(jnp.float32), src, \
            omega.astype(jnp.float32), x

    eps, mu, src, omega, x = jax.vmap(one)(keys)
    return eps, mu, src, omega, x


@partial(jax.jit, static_argnames=("shape", "batch", "pml_thickness", "dx"))
def _generate_batch_compact_device(key, *, batch: int, shape: Tuple[int, int],
                                   dx: float, pml_thickness: int):
    """Device half of the fast datagen path: solve + compact encodings.

    Returns (eps_mask u8, src_mask u8, omega f32, re f32, im f32). The scene
    channels are structurally redundant (binary eps, 0/1 src, constant mu —
    reference diffusion_training.py:54-146), and complex64 IS a pair of
    float32s, so this is the minimal-byte exact fetch: ~0.65 MB/sample at
    256^2 vs ~2.3 MB for the old full-float path."""
    eps, mu, src, omega, x = _generate_batch_direct_device(
        key, batch=batch, shape=shape, dx=dx, pml_thickness=pml_thickness)
    mid = jnp.float32(0.5 * (EPS_LO + EPS_HI))
    return ((eps > mid).astype(jnp.uint8), (src != 0).astype(jnp.uint8),
            omega, jnp.real(x), jnp.imag(x))


def _finish_batch_host(dev, dx: float, pml_thickness: int) -> dict:
    """Host half: fetch the compact encodings, rebuild the float channels,
    and run the TRUE-f64 residual check. complex64 fetched as f32 parts is
    bit-identical to the old f64-part fetch at half the bytes."""
    eps_mask, src_mask, omega, re, im = dev
    re = np.asarray(re, np.float32)
    im = np.asarray(im, np.float32)
    eps_mask = np.asarray(eps_mask, bool)
    src = np.asarray(src_mask, np.float32)
    omega = np.asarray(omega, np.float32)
    eps = np.where(eps_mask, np.float32(EPS_HI), np.float32(EPS_LO))
    mu = np.broadcast_to(np.float32(MU_REF), eps.shape)
    x_host = re.astype(np.float64) + 1j * im.astype(np.float64)
    res = _five_point_residual_host(eps, mu, src, omega, x_host, dx,
                                    pml_thickness)
    return dict(eps=eps, mu=mu, src=src, omega=omega, Ez=re,
                residuals=res.astype(np.float32))


def generate_batch(key, *, batch: int, shape: Tuple[int, int], dx: float = 1e-3,
                   pml_thickness: int = 40, M=None, **_ignored):
    """One batch of (eps, mu, src, omega, Ez) training samples.

    Labels are EXACT: each sample is solved with the sublattice block-Thomas
    direct factorization (fdtd2d/fdfd/direct.py) plus one c64 refinement
    round — method parity with the reference's f64 spsolve labels
    (python-src/diffusion_training.py:36-51), on device. ``residuals`` holds
    per-sample TRUE f64 relative residuals evaluated host-side (typically
    ~1e-6; the round-2 Krylov path left ~90% of samples above 1e-4).
    Arrays come back as host numpy (the compact fetch path above); for
    device-resident batches wrap with jnp.asarray."""
    del M
    dev = _generate_batch_compact_device(key, batch=batch, shape=shape,
                                         dx=dx, pml_thickness=pml_thickness)
    return _finish_batch_host(dev, dx, pml_thickness)


def default_preconditioner(shape: Tuple[int, int], dx: float = 1e-3,
                           pml_thickness: int = 40, omega_ref: float = 24e9):
    """Shared mid-band FDM preconditioner for datagen batches."""
    return fdm_preconditioner(shape[0], shape[1], dx, dx, omega_ref,
                              pml_thickness, eps_ref=2.0 * EPS_LO, mu_ref=MU_REF)


def generate_dataset(key, num_samples: int, shape: Tuple[int, int],
                     batch: int = 64, to_host: bool | None = None,
                     dx: float = 1e-3, pml_thickness: int = 40, **kwargs):
    """Generate ``num_samples`` in device-sized batches; returns a stacked
    host-numpy dict.

    Double-buffered: batch i+1's device solve is dispatched (async) BEFORE
    batch i's host fetch + f64 residual check, so the transfer and host
    work overlap the next solve.
    ``to_host`` is kept for API compatibility; results are always host-side
    now (the compact fetch made device-side accumulation pointless).
    """
    kwargs.pop("M", None)  # unused by the direct path; kept for API compat
    del to_host
    outs = []
    pending = None
    n = 0
    while n < num_samples:
        key, k = jax.random.split(key)
        b = min(batch, num_samples - n)
        dev = _generate_batch_compact_device(k, batch=b, shape=shape, dx=dx,
                                             pml_thickness=pml_thickness)
        if pending is not None:
            outs.append(_finish_batch_host(pending, dx, pml_thickness))
        pending = dev
        n += b
    outs.append(_finish_batch_host(pending, dx, pml_thickness))
    return jax.tree.map(lambda *xs: np.concatenate(xs), *outs)


# ---------------------------------------------------------------------------
# Dataset storage: compact npz + resumable shards
# ---------------------------------------------------------------------------
#
# A 50k-scene 256^2 dataset is ~52 GB as five float32 arrays. The scene
# channels are structurally redundant: eps is BINARY (exactly EPS_LO or
# EPS_HI, random_permittivity above), src is a 0/1 mask, and mu is the
# constant MU_REF everywhere (reference python-src/diffusion_training.py:54-146
# draws only eps/src/omega). Compact storage keeps uint8 masks for eps/src,
# drops mu, and stores only the label Ez (float32 — field norms span orders
# of magnitude, so float16 would clip) — ~17 GB for 50k scenes.

_COMPACT_VERSION = 1


def save_dataset(path: str, data: dict, compact: bool = True) -> None:
    """Write a dataset npz; ``compact=True`` uses the mask encoding above.

    Atomic: writes to ``<path>.tmp.npz`` then renames, so an interrupted
    save never leaves a truncated npz behind.
    """
    import os

    arrs = {k: np.asarray(v) for k, v in data.items()}
    if compact:
        mid = np.float32(0.5 * (EPS_LO + EPS_HI))
        out = {
            "eps_mask": (arrs["eps"] > mid).astype(np.uint8),
            "src_mask": (arrs["src"] != 0).astype(np.uint8),
            "omega": arrs["omega"].astype(np.float32),
            "Ez": arrs["Ez"].astype(np.float32),
            "compact_version": np.int32(_COMPACT_VERSION),
        }
        if "residuals" in arrs:
            out["residuals"] = arrs["residuals"].astype(np.float32)
        arrs = out
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrs)
    os.replace(tmp, path)


def _decode_compact(raw: dict) -> dict:
    mask = np.asarray(raw["eps_mask"], bool)
    out = {
        "eps": np.where(mask, np.float32(EPS_HI), np.float32(EPS_LO)),
        # zero-copy constant view; chunked/batched indexing materializes
        # only the slices it touches
        "mu": np.broadcast_to(np.float32(MU_REF), mask.shape),
        "src": np.asarray(raw["src_mask"], np.float32),
        "omega": np.asarray(raw["omega"]),
        "Ez": np.asarray(raw["Ez"]),
    }
    if "residuals" in raw:
        out["residuals"] = np.asarray(raw["residuals"])
    return out


def load_dataset(path: str, decode: bool = True) -> dict:
    """Load a dataset from a plain npz, a compact npz, or a DIRECTORY of
    ``shard_*.npz`` files written by :func:`generate_dataset_shards`
    (shards are concatenated in filename order).

    ``decode=False`` returns compact-stored data in its RAW mask form
    (``eps_mask``/``src_mask`` uint8 + ``omega``/``Ez`` float32) instead of
    materializing the full float32 channels — the input format of
    :func:`fdtd2d.models.train.train`'s ``device_dtype="compact"``
    HBM-resident cache (a 50k-scene 256² dataset is ~13 GB compact vs
    ~52 GB decoded)."""
    import glob
    import os

    if os.path.isdir(path):
        shards = sorted(glob.glob(os.path.join(path, "shard_*.npz")))
        if not shards:
            raise FileNotFoundError(f"no shard_*.npz files in {path}")
        parts = [np.load(p) for p in shards]
        keys = [k for k in parts[0].files if k != "compact_version"]
        raw = {k: (np.concatenate([p[k] for p in parts])
                   if parts[0][k].ndim else parts[0][k][()])
               for k in keys}
        if "compact_version" in parts[0].files:
            raw["compact_version"] = parts[0]["compact_version"][()]
    else:
        with np.load(path) as f:
            raw = {k: f[k] for k in f.files}
    if "eps_mask" in raw and decode:
        return _decode_compact(raw)
    raw.pop("compact_version", None)
    return raw


def generate_dataset_shards(key, num_samples: int, shape: Tuple[int, int],
                            out_dir: str, shard_size: int = 2048,
                            batch: int = 32, compact: bool = True,
                            verbose: bool = True, **kwargs) -> int:
    """Resumable sharded datagen: writes ``shard_%05d.npz`` under
    ``out_dir``, skipping shards that already exist, so an interrupted run
    (a lost device, a restarted machine) resumes where it left off.

    Each shard's RNG key is ``fold_in(key, shard_index)`` — the dataset is
    reproducible regardless of which shards were present. Returns the
    number of shards written this call.
    """
    import os

    os.makedirs(out_dir, exist_ok=True)
    n_shards = -(-num_samples // shard_size)
    written = 0
    for i in range(n_shards):
        path = os.path.join(out_dir, f"shard_{i:05d}.npz")
        if os.path.exists(path):
            continue
        n_i = min(shard_size, num_samples - i * shard_size)
        data = generate_dataset(jax.random.fold_in(key, i), n_i, shape,
                                batch=batch, to_host=True, **kwargs)
        save_dataset(path, data, compact=compact)
        written += 1
        if verbose:
            worst = float(np.max(np.asarray(data["residuals"])))
            print(f"shard {i + 1}/{n_shards}: {n_i} samples, "
                  f"worst residual {worst:.2e}", flush=True)
    return written
