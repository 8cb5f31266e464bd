"""ctypes bindings for the native C++ host engine (built on demand).

See fdtd2d_native.cpp for scope. The library is compiled once per
environment with g++ (no pybind11 dependency) and cached next to the source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fdtd2d_native.cpp")
_LIB = os.path.join(_HERE, "libfdtd2d_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> str:
    """Compile the shared library if needed; returns its path."""
    with _lock:
        if force or not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            # build under a per-process name, then rename: processes that
            # import this module at once (test workers) never load a
            # half-written library
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
                   _SRC, "-o", tmp]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except subprocess.CalledProcessError:
                # retry without OpenMP (not all toolchains ship libgomp)
                cmd = [c for c in cmd if c != "-fopenmp"]
                subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, _LIB)
    return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        c_d = ctypes.c_double
        c_i64 = ctypes.c_int64
        c_i32 = ctypes.c_int32
        pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        pz = np.ctypeslib.ndpointer(np.complex128, flags="C_CONTIGUOUS")
        lib.fdtd_step.argtypes = [pd, pd, pd, pd, pd, c_d, c_d, c_i64, c_i64]
        lib.fdtd_run.argtypes = [pd, pd, pd, pd, pd, c_d, c_d, c_i64, c_i64,
                                 c_i64, c_i64, c_i64, c_d, c_i32, c_i64]
        lib.helmholtz_matvec.argtypes = [pz, pz, pd, pd, pz, pz,
                                         c_d, c_d, c_d, c_i64, c_i64]
        lib.native_num_threads.restype = c_i32
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def fdtd_step(Ez, Hx, Hy, eps, mu, dt: float, dx: float):
    """One in-place leapfrog step (float64 arrays, reference semantics)."""
    lib = _load()
    Ez = np.ascontiguousarray(Ez, np.float64)
    Hx = np.ascontiguousarray(Hx, np.float64)
    Hy = np.ascontiguousarray(Hy, np.float64)
    rows, cols = Ez.shape
    lib.fdtd_step(Ez, Hx, Hy, np.ascontiguousarray(eps, np.float64),
                  np.ascontiguousarray(mu, np.float64), dt, dx, rows, cols)
    return Ez, Hx, Hy


def fdtd_run(eps, mu, dt: float, dx: float, nsteps: int,
             source_xy: Tuple[int, int], fc: float, kind: str = "ricker",
             state=None, step_offset: int = 0):
    """Full rollout with additive point source; returns (Ez, Hx, Hy)."""
    lib = _load()
    eps = np.ascontiguousarray(eps, np.float64)
    mu = np.ascontiguousarray(mu, np.float64)
    rows, cols = eps.shape
    if state is None:
        Ez = np.zeros((rows, cols))
        Hx = np.zeros((rows, cols - 1))
        Hy = np.zeros((rows - 1, cols))
    else:
        Ez, Hx, Hy = (np.ascontiguousarray(s, np.float64) for s in state)
    lib.fdtd_run(Ez, Hx, Hy, eps, mu, dt, dx, rows, cols, nsteps,
                 source_xy[0], source_xy[1], fc,
                 0 if kind == "ricker" else 1, step_offset)
    return Ez, Hx, Hy


def helmholtz_matvec(x, eps, mu, inv_s_row, inv_s_col,
                     inv_2dx: float, inv_2dy: float, omega: float):
    """y = A x for the UPML Helmholtz operator (complex128)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.complex128)
    Nx, Ny = x.shape
    y = np.empty_like(x)
    lib.helmholtz_matvec(
        x, y, np.ascontiguousarray(eps, np.float64),
        np.ascontiguousarray(1.0 / np.asarray(mu), np.float64),
        np.ascontiguousarray(inv_s_row, np.complex128),
        np.ascontiguousarray(inv_s_col, np.complex128),
        inv_2dx, inv_2dy, omega, Nx, Ny)
    return y


def num_threads() -> int:
    return int(_load().native_num_threads())
