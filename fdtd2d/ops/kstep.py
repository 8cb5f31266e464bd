"""K-step temporally blocked FDTD sweep: CUDA kernel for Hopper + its plain
JAX reference.

One sweep advances the padded-layout fields (fdtd/step.py's
``fdtd_step_padded`` convention, every array (R, C)) by ``nsteps <= halo``
leapfrog steps. The CUDA kernel (``fdtd_kstep.cu``) does it in 2-D tiles
held in shared memory, so device memory is read and written once per sweep
instead of once per step; :func:`sweep_reference` is the same contract in
plain JAX and is what the CPU tests run.

The contract, shared by both implementations:

- rows ``[row0, row1)`` are the domain rows this array owns; rows outside
  are ghost rows a sharded caller refreshes between sweeps (the kernel
  leaves them unwritten in its output);
- the Mur top band sits at ``row0`` when ``is_top``, the bottom band ends
  at ``row1 - 1`` when ``is_bot``; the left/right bands at columns 0 and
  C-1 are always applied;
- ``fparams = [coef, dt, fc]`` (f32), ``iparams = [t0, src_row, src_col,
  is_top, is_bot]`` (s32, array coordinates), device arrays so that one
  SPMD program can pass per-device values.

The shared library is compiled with ``nvcc`` from the source beside this
file at first use, into ``<checkout>/.cache/kernels`` (git-ignored), and
registered as an XLA FFI target. There is no interpret mode: the kernel
runs only on an NVIDIA GPU of compute capability 9.0 (``sm_90a``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import jax
import jax.numpy as jnp

from fdtd2d.core.sources import ricker_amplitude, sinusoidal_amplitude
from fdtd2d.fdtd.step import MUR_BAND
from fdtd2d.utils.cache import CACHE_ROOT

WEXT, HEXT = 128, 96          # loaded tile, fixed in the kernel
SMEM_PER_BLOCK = 232448       # Hopper's largest shared-memory allocation
DEFAULT_K = 12                # steps per sweep (= halo width)
SOURCE_KINDS = ("ricker", "sinusoidal")

_TARGET = "fdtd2d_kstep"
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fdtd_kstep.cu")
_lock = threading.Lock()
_registered = False


# ---------------------------------------------------------------------------
# Tile plan (what the kernel launches; pure Python so CPU tests reach it)
# ---------------------------------------------------------------------------


def tile_plan(rows: int, cols: int, halo: int):
    """Launch geometry for ``rows`` owned rows of ``cols`` columns.

    Returns ``(TY, TX, grid_y, grid_x, smem_bytes)``: each block writes a
    TY x TX tile and loads it with ``halo`` cells on every side. Raises
    ValueError for plans the kernel refuses."""
    TY, TX = HEXT - 2 * halo, WEXT - 2 * halo
    if halo < 1 or TY < 1:
        raise ValueError(f"halo={halo}: need 1 <= halo < {HEXT // 2} for "
                         f"{HEXT}-row blocks")
    if cols < 2 * (MUR_BAND + 1) or rows < MUR_BAND + 1:
        raise ValueError(f"{rows}x{cols} is below the Mur band width")
    smem = 4 * HEXT * WEXT * 4
    assert smem <= SMEM_PER_BLOCK
    return TY, TX, -(-rows // TY), -(-cols // TX), smem


# ---------------------------------------------------------------------------
# Build + FFI registration
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kstep kernel is built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_library() -> str:
    """Compile ``fdtd_kstep.cu`` for sm_90a if not built yet; return the
    path of the shared library (named by the source's hash)."""
    include = jax.ffi.include_dir()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", include]
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    out_dir = os.path.join(CACHE_ROOT, "kernels")
    lib = os.path.join(out_dir, f"libfdtd_kstep-{digest[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _ensure_registered() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        if jax.devices()[0].platform != "gpu":
            raise RuntimeError("the kstep kernel runs only on an NVIDIA GPU; "
                               f"found {jax.devices()[0].platform!r}")
        lib = ctypes.cdll.LoadLibrary(build_library())
        jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(lib.FdtdKstep),
                                    platform="CUDA")
        _registered = True


# ---------------------------------------------------------------------------
# One sweep: kernel and reference
# ---------------------------------------------------------------------------


def _sweep_cuda(ez, hx, hy, ce, ch, fparams, iparams, *, halo, nsteps, row0,
                row1, kind):
    if any(a.dtype != jnp.float32 for a in (ez, hx, hy, ce, ch, fparams)):
        raise TypeError("the kstep kernel takes float32 fields and coefficients")
    tile_plan(row1 - row0, ez.shape[1], halo)
    _ensure_registered()
    out = jax.ShapeDtypeStruct(ez.shape, jnp.float32)
    return jax.ffi.ffi_call(_TARGET, (out, out, out))(
        ez, hx, hy, ce, ch, fparams, iparams, halo=np.int32(halo), nsteps=np.int32(nsteps), row0=np.int32(row0),
        row1=np.int32(row1), kind=np.int32(kind))


def _reference_step(ez, hx, hy, ce, ch, coef, row0, row1, is_top, is_bot):
    """One step of the kernel's contract on the whole array."""
    b = MUR_BAND
    P = ez
    hx = hx.at[:-1, :].add(-ch[:-1, :] * (ez[1:, :] - ez[:-1, :]))
    hy = hy.at[:, :-1].add(ch[:, :-1] * (ez[:, 1:] - ez[:, :-1]))
    curl = (hy[1:, 1:] - hy[1:, :-1]) - (hx[1:, 1:] - hx[:-1, 1:])
    E = P.at[1:, 1:].add(ce[1:, 1:] * curl)

    E = E.at[:, 0:b].set(P[:, 1 : b + 1] + coef * (E[:, 1 : b + 1] - P[:, 0:b]))
    E = E.at[:, -b:].set(P[:, -b - 1 : -1] + coef * (E[:, -b - 1 : -1] - P[:, -b:]))

    t, e = row0, row1
    top = P[t + 1 : t + b + 1, 1:-1] + coef * (
        E[t + 1 : t + b + 1, 1:-1] - P[t : t + b, 1:-1])
    bot = P[e - b - 1 : e - 1, 1:-1] + coef * (
        E[e - b - 1 : e - 1, 1:-1] - P[e - b : e, 1:-1])
    E = jnp.where(is_top, E.at[t : t + b, 1:-1].set(top), E)
    E = jnp.where(is_bot, E.at[e - b : e, 1:-1].set(bot), E)

    tl = (E[t : t + b, 1 : b + 1] + E[t + 1 : t + b + 1, 0:b]) * 0.5
    tr = (E[t : t + b, -b - 1 : -1] + E[t + 1 : t + b + 1, -b:]) * 0.5
    bl = (E[e - b - 1 : e - 1, 0:b] + E[e - b : e, 1 : b + 1]) * 0.5
    br = (E[e - b - 1 : e - 1, -b:] + E[e - b : e, -b - 1 : -1]) * 0.5
    E = jnp.where(is_top, E.at[t : t + b, 0:b].set(tl).at[t : t + b, -b:].set(tr), E)
    E = jnp.where(is_bot, E.at[e - b : e, 0:b].set(bl).at[e - b : e, -b:].set(br), E)
    return E, hx, hy


def sweep_reference(ez, hx, hy, ce, ch, fparams, iparams, *, halo, nsteps,
                    row0, row1, kind):
    """Plain-JAX sweep with the kernel's contract (ghost rows evolve here
    instead of being left unwritten; callers overwrite them either way)."""
    del halo
    coef, dt, fc = fparams[0], fparams[1], fparams[2]
    t0, sr, sc, is_top, is_bot = (iparams[i] for i in range(5))
    rows = jax.lax.broadcasted_iota(jnp.int32, ez.shape, 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, ez.shape, 1)
    hot = ((rows == sr) & (cols == sc)).astype(ez.dtype)
    amp_fn = (ricker_amplitude, sinusoidal_amplitude)[kind]

    def body(s, carry):
        ez, hx, hy = _reference_step(*carry, ce, ch, coef, row0, row1,
                                     is_top != 0, is_bot != 0)
        t = (t0 + s).astype(ez.dtype) * dt
        return ez + amp_fn(t, fc).astype(ez.dtype) * hot, hx, hy

    return jax.lax.fori_loop(0, nsteps, body, (ez, hx, hy))


IMPLS = {"cuda": _sweep_cuda, "reference": sweep_reference}


# ---------------------------------------------------------------------------
# Single-device multi-step driver
# ---------------------------------------------------------------------------


def to_padded_layout(Hx, Hy, ce, ch, shape):
    """Staggered (Hx (N, M-1), Hy (N-1, M), ch (N-1, M-1)) -> all (N, M);
    ce gets its outer ring zeroed (the reference never interior-updates it).
    Arrays already (N, M) pass through unchanged."""
    N, M = shape
    pad_to = lambda a: jnp.pad(a, ((0, N - a.shape[0]), (0, M - a.shape[1])))
    ce = jnp.asarray(ce, jnp.float32)
    ce = ce.at[0, :].set(0.0).at[-1, :].set(0.0).at[:, 0].set(0.0).at[:, -1].set(0.0)
    return pad_to(Hx), pad_to(Hy), ce, pad_to(jnp.asarray(ch, jnp.float32))


def advance_padded(ez, hx, hy, ce, ch, coef, dt, fc, sx: int, sy: int,
                   nsteps: int, source_kind: str, step_offset, *,
                   K: int = DEFAULT_K, impl: str = "cuda"):
    """Advance padded-layout fields (all (N, M), ``ce`` ring-masked: see
    :func:`to_padded_layout`) ``nsteps`` steps from global step
    ``step_offset`` in ``ceil(nsteps / K)`` sweeps."""
    N, M = ez.shape
    tile_plan(N, M, K)
    sweep = IMPLS[impl]
    kind = SOURCE_KINDS.index(source_kind)
    fparams = jnp.stack([jnp.asarray(v, jnp.float32) for v in (coef, dt, fc)])
    off = jnp.asarray(step_offset, jnp.int32)
    tail = jnp.asarray([sx, sy, 1, 1], jnp.int32)

    def run(fields, t0, n):
        iparams = jnp.concatenate([t0.reshape(1), tail])
        return sweep(*fields, ce, ch, fparams, iparams, halo=K, nsteps=n,
                     row0=0, row1=N, kind=kind)

    nsweeps, rem = divmod(nsteps, K)
    fields = (ez, hx, hy)
    if nsweeps:
        fields = jax.lax.fori_loop(
            0, nsweeps, lambda k, f: run(f, off + k * K, K), fields)
    if rem:
        fields = run(fields, off + nsweeps * K, rem)
    return fields


def fdtd_multistep_kstep(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx: int, sy: int,
                         nsteps: int, source_kind: str, step_offset, **kw):
    """:func:`advance_padded` for fields in the staggered or the padded
    convention; they come back in the shapes they came in."""
    shapes = (Hx.shape, Hy.shape)
    hxp, hyp, cep, chp = to_padded_layout(Hx, Hy, ce, ch, Ez.shape)
    ez, hx, hy = advance_padded(Ez, hxp, hyp, cep, chp, coef, dt, fc, sx, sy,
                                nsteps, source_kind, step_offset, **kw)
    return ez, hx[: shapes[0][0], : shapes[0][1]], hy[: shapes[1][0], : shapes[1][1]]
