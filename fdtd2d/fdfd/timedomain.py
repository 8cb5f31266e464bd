"""Wavelength-robust FDFD solve: a frequency-locked time-domain solver.

The round-3 iterative stack (FDM-FGMRES, two-level ORAS — fdfd/solver.py,
fdfd/tiled.py) hits the classical indefinite-Helmholtz wall: iteration
counts grow with the electrical size k*L, and at 4096^2 / 17 GHz
(~232 wavelengths across) even contrast-1.5 scenes stall near 6e-2
relative residual (measured boundary, fdfd/tiled.py:38-47). The direct
factorizations (fdfd/direct.py) are contrast- and size-robust but pay a
factor-memory wall past ~1448^2.

This module replaces both with the oldest wavelength-robust idea there is,
rebuilt for the accelerator: solve the time-HARMONIC problem by running the time-
DOMAIN wave equation to steady state — cost is linear in domain transits
(O(k*L) steps of an O(N^2) memory-bound stencil), independent of material-
contrast conditioning, and needs NO stored factors at all. It is the
frequency-domain sibling of the FDTD engine this framework is named for:
the solver IS an FDTD run on the FDFD's own stencil.

Structure (see fdfd/direct.py:8-28): the outrigger operator A = S - w^2 eps
decouples by (i mod 2, j mod 2) into FOUR independent 5-point systems on
half-resolution sublattices, where the stretched stencil factorizes
per axis as

    S = S_col + S_row,    S_col u = isc (.) [ M_col ( isc (.) u ) ],

with M_col a REAL tridiagonal stencil and isc = 1/s_col the per-CELL
complex PML stretch (ops/helmholtz.py:51-57; the same holds for rows).
We time-step the driven leapfrog

    eps (u[k+1] - 2 u[k] + u[k-1]) / dt^2  =  -(S u)[k] + b e^{-i theta k}

where each of the four pointwise stretch multiplications is realized by a
trapezoidal (bilinear) one-pole filter on a thin PML strip — CPML-style
auxiliary variables that are simultaneously PASSIVE and EXACT at the drive
frequency:

    psi[k] = d0 psi[k-1] + gg (x[k] + x[k-1]),
    d0 = (1 - h) / (1 + h),   gg = -h / (1 + h),
    h = sigma dt / (2 eps0 cos(theta/2)),
    (stretched x)[k] = x[k] + psi[k] .

Why this works: the target stretch response 1/s - 1 = -g_t/(g_t - i w)
(g_t = sigma/eps0) lies ON the one-pole low-pass family -g/(g + s'), so a
bilinear discretization — which evaluates that family at the warped
frequency w_tan = (2/dt) tan(theta/2) instead of w — hits the target
EXACTLY after the conductivity rescale g = g_t * w_tan / w =
g_t / cos(theta/2). Bilinear preserves passivity and the coefficients are
real (conjugate-symmetric response), so the filters absorb at EVERY
frequency — unlike the complex-gain one-pole (anti-damps mirror-frequency
modes, 188 growing eigenmodes at |eig| = 1.0089 in the 32^2 update-operator
probe), the plain forward-Euler CPML (textbook DC drift, 4 modes at
1.00018), and the drive-resonant real biquad (anti-damps near-resonant
modes via the +-90 degree phase slew; band residual grew with run length).

At the drive frequency the filter transfer is (isc - 1) exactly, so the
steady state u[k] = U e^{-i theta k} of the whole LTI system satisfies

    (S - wt^2 eps) U = b,     wt = (2/dt) sin(theta/2),

and choosing theta = 2 asin(w dt / 2) makes wt = w EXACTLY. The steady
state therefore satisfies the FDFD system to machine precision EVERYWHERE
— interior (zero-truncated edges included) and PML band alike. The only
approximation is the not-yet-decayed transient, which the ramped drive,
the absorbing filters, and a final one-period phasor average suppress
geometrically in the number of settling transits (measured on the sponge
predecessor of this scheme: interior residual 3.5e-3 at 2.5 transits,
1.7e-5 at 12; the sponge's PML-band mismatch floored at 2e-1, which is
what the exact filters remove).

Mixed-precision refinement (fdfd/refine.py) wraps the wave run and
contracts the TRUE f64 residual by the per-application transient level
per round.

Why this maps to an accelerator: one step is a 5-point complex stencil —
pure memory bandwidth, the shape of the FDTD step (fdtd/step.py).
For constant-mu scenes (the reference only ever uses uniform mu,
python-src/diffusion_training.py:93) all stencil coefficients are
(row-vector + col-vector) separable, so the step streams only u / u_prev /
b plus strip-resident filter state — ~32 B/cell/step — and the whole
four-sublattice batch runs as one (4, nr, nc) scan under a single jit.

Reference parity note: the reference has no wavelength-robust solver at
all — its scaling story ends at the stationary tiled sweep
(python-src/tiled_solver.py:111-224), which carries O(10%) field bias and
stalls identically with electrical size.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fdtd2d import constants
from fdtd2d.ops.helmholtz import pml_sigma_profile

_PARITIES = ((0, 0), (0, 1), (1, 0), (1, 1))


def _sub_stack(a: np.ndarray) -> np.ndarray:
    """(Nx, Ny) -> (4, Nx/2, Ny/2) sublattice stack in _PARITIES order."""
    return np.stack([a[px::2, py::2] for (px, py) in _PARITIES])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WaveBundle:
    """Device-resident sublattice wave-stepping data.

    Real stencil (two layouts share one stepping kernel):

    - separable (constant mu; ``dense=False``): per-axis coefficients are
      (4, nr) row vectors / (4, nc) column vectors — near-zero memory traffic.
    - dense (``dense=True``): full (4, nr, nc) arrays in the row-vector
      fields; column-vector fields are zero placeholders.

    Filter parameters (trapezoidal one-pole, passive AND exact at the
    drive — see the module docstring): real per-cell pole d0 and gain gg on
    the two PML strips of each axis, stored strip-packed: column filters as
    (4, 1, 2t) with [left t | right t], row filters as (4, 2t, 1) with
    [top t | bottom t].
    """

    # real per-axis stencil M_col / M_row
    dc: jax.Array       # f32 (4, nc) or dense (4, nr, nc)
    dr: jax.Array       # f32 (4, nr) or dense (4, nr, nc)
    e_c: jax.Array      # coupling to (r, c+1): (4, nc) or (4, nr, nc)
    w_c: jax.Array      # coupling to (r, c-1)
    s_r: jax.Array      # coupling to (r+1, c): (4, nr) or (4, nr, nc)
    n_r: jax.Array      # coupling to (r-1, c)
    inv_eps_dt2: jax.Array   # f32 (4, nr, nc)
    # trapezoidal filters: all f32; strip width t (static)
    d0_col: jax.Array   # (4, 1, 2t)
    gg_col: jax.Array   # (4, 1, 2t)
    d0_row: jax.Array   # (4, 2t, 1)
    gg_row: jax.Array   # (4, 2t, 1)
    # band stabilizer: tiny CENTERED sponge (u[k+1]-u[k-1])/2dt over the
    # PML band only. The filter+leapfrog coupling has a slow residual
    # growth (measured max|eig| ~ 1.00016 across configs in the update-
    # operator probe, independent of the CFL safety factor); a centered
    # sponge of h_d per step suppresses it with margin at the cost of an
    # O(2 h_d / theta) relative operator perturbation confined to the band
    # — which the outer refinement contracts through per round.
    hd_r: jax.Array     # f32 (4, nr) half-damping rows
    hd_c: jax.Array     # f32 (4, nc)
    theta: jax.Array    # f32 scalar, drive phase per step
    dense: bool = dataclasses.field(metadata=dict(static=True))
    t: int = dataclasses.field(metadata=dict(static=True))
    n_main: int = dataclasses.field(metadata=dict(static=True))
    n_avg: int = dataclasses.field(metadata=dict(static=True))
    n_ramp: int = dataclasses.field(metadata=dict(static=True))


def _col_strips(u, t):
    """(…, nr, nc) -> (…, nr, 2t): [left t | right t] columns."""
    return jnp.concatenate([u[..., :t], u[..., -t:]], axis=-1)


def _row_strips(u, t):
    return jnp.concatenate([u[..., :t, :], u[..., -t:, :]], axis=-2)


def _add_col_strips(u, v, t):
    u = u.at[..., :t].add(v[..., :t])
    return u.at[..., -t:].add(v[..., t:])


def _add_row_strips(u, v, t):
    u = u.at[..., :t, :].add(v[..., :t, :])
    return u.at[..., -t:, :].add(v[..., t:, :])


def _m_col(b: WaveBundle, u):
    """Real per-axis stencil M_col (diag + e/w couplings)."""
    up = jnp.pad(u[:, :, 1:], ((0, 0), (0, 0), (0, 1)))
    um = jnp.pad(u[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
    if b.dense:
        return b.dc * u + b.e_c * up + b.w_c * um
    c = lambda v: v[:, None, :]
    return c(b.dc) * u + c(b.e_c) * up + c(b.w_c) * um


def _m_row(b: WaveBundle, u):
    vp = jnp.pad(u[:, 1:, :], ((0, 0), (0, 1), (0, 0)))
    vm = jnp.pad(u[:, :-1, :], ((0, 0), (1, 0), (0, 0)))
    if b.dense:
        return b.dr * u + b.s_r * vp + b.n_r * vm
    r = lambda v: v[:, :, None]
    return r(b.dr) * u + r(b.s_r) * vp + r(b.n_r) * vm


def _psi0(b_sub: jax.Array, t: int):
    """Zero filter state for :func:`_apply_S`: psi per filter (u-col,
    u-row, q-col, q-row) plus the lagged q strips (the u filters reuse
    uprev from the leapfrog carry)."""
    B, nr, nc = b_sub.shape
    zc = jnp.zeros((B, nr, 2 * t), b_sub.dtype)
    zr = jnp.zeros((B, 2 * t, nc), b_sub.dtype)
    return (zc, zr, zc, zr, zc, zr)


def _apply_S(b: WaveBundle, u, uprev, psi):
    """One filtered application of the stretched stencil S u, plus the
    next filter state. Trapezoidal filters update at the START of the step
    from the current and previous inputs, so the psi used alongside x[k]
    is the one whose transfer relation involves x[k] itself (the bilinear
    form in the module docstring)."""
    p_uc, p_ur, p_qc, p_qr, qcp, qrp = psi
    t = b.t
    trap = lambda p, d0, gg, x, xp: d0 * p + gg * (x + xp)
    p_uc = trap(p_uc, b.d0_col, b.gg_col,
                _col_strips(u, t), _col_strips(uprev, t))
    p_ur = trap(p_ur, b.d0_row, b.gg_row,
                _row_strips(u, t), _row_strips(uprev, t))
    uc = _add_col_strips(u, p_uc, t)          # isc (.) u   (steady state)
    ur = _add_row_strips(u, p_ur, t)
    qc = _m_col(b, uc)
    qr = _m_row(b, ur)
    qcs = _col_strips(qc, t)
    qrs = _row_strips(qr, t)
    p_qc = trap(p_qc, b.d0_col, b.gg_col, qcs, qcp)
    p_qr = trap(p_qr, b.d0_row, b.gg_row, qrs, qrp)
    su = (_add_col_strips(qc, p_qc, t)        # isc (.) q
          + _add_row_strips(qr, p_qr, t))
    return su, (p_uc, p_ur, p_qc, p_qr, qcs, qrs)


def _step(bundle: WaveBundle, b_sub, u, uprev, psi, k):
    """One driven leapfrog step at absolute step index ``k``."""
    theta = bundle.theta
    n_ramp = jnp.float32(bundle.n_ramp)
    kf = k.astype(jnp.float32)
    ramp = jnp.sin(0.5 * jnp.pi * jnp.minimum(kf, n_ramp) / n_ramp) ** 2
    ph = (jnp.cos(theta * kf) - 1j * jnp.sin(theta * kf)).astype(
        jnp.complex64) * ramp
    su, psi = _apply_S(bundle, u, uprev, psi)
    # rank-1 band sponge, broadcast in-register (never materialized)
    hd = bundle.hd_r[:, :, None] + bundle.hd_c[:, None, :]
    unew = (2.0 * u - (1.0 - hd) * uprev
            + bundle.inv_eps_dt2 * (b_sub * ph - su)) / (1.0 + hd)
    return unew, u, psi


@partial(jax.jit, static_argnames=("nsteps",))
def _settle_segment(bundle: WaveBundle, b_sub, u, uprev, psi, k0, *,
                    nsteps: int):
    """``nsteps`` settling steps from absolute index ``k0`` — one bounded
    device dispatch (see :func:`wave_run_chunked`; TrainConfig.
    max_dispatch_steps bounds training scans the same way)."""
    def body(carry, k):
        u, uprev, psi = carry
        unew, u, psi = _step(bundle, b_sub, u, uprev, psi, k)
        return (unew, u, psi), None

    (u, uprev, psi), _ = jax.lax.scan(body, (u, uprev, psi),
                                      k0 + jnp.arange(nsteps))
    return u, uprev, psi


# dispatch-ending sync: real f32 scalar of a complex array, computed under
# jit (eager complex scalar ops are UNIMPLEMENTED on this backend)
_fetch_real = jax.jit(lambda u: jnp.sum(jnp.real(u[0])))


@jax.jit
def _avg_run(bundle: WaveBundle, b_sub, u, uprev, psi):
    """Final one-period phasor average (n_avg steps, one dispatch)."""
    theta = bundle.theta

    def body_avg(carry, k):
        (u, uprev, psi), acc = carry
        unew, u, psi = _step(bundle, b_sub, u, uprev, psi, k)
        kf = (k + 1).astype(jnp.float32)
        ph = (jnp.cos(theta * kf) + 1j * jnp.sin(theta * kf)).astype(
            jnp.complex64)
        return ((unew, u, psi), acc + unew * ph), None

    ks = jnp.arange(bundle.n_main, bundle.n_main + bundle.n_avg)
    (_, acc), _ = jax.lax.scan(body_avg, ((u, uprev, psi),
                                          jnp.zeros_like(u)), ks)
    return acc / jnp.float32(bundle.n_avg)


@jax.jit
def wave_run(bundle: WaveBundle, b_sub: jax.Array) -> jax.Array:
    """~A_sub^{-1} b_sub for all four sublattices at once, ONE dispatch.

    ``b_sub``: (4, nr, nc) complex64. Runs ``n_main`` settling steps from
    zero, then averages the phasor u[k] e^{+i theta k} over the final
    ``n_avg`` steps (one drive period) — the period average cancels
    residual transients at frequencies != the drive to first order.

    For large grids use :func:`wave_run_chunked` — at 4096^2 the full
    settle can be a multi-minute dispatch."""
    def body_main(carry, k):
        u, uprev, psi = carry
        unew, u, psi = _step(bundle, b_sub, u, uprev, psi, k)
        return (unew, u, psi), None

    u0 = jnp.zeros_like(b_sub)
    (u, uprev, psi), _ = jax.lax.scan(body_main, (u0, u0, _psi0(b_sub, bundle.t)),
                                      jnp.arange(bundle.n_main))
    return _avg_run(bundle, b_sub, u, uprev, psi)


def wave_run_chunked(bundle: WaveBundle, b_sub: jax.Array,
                     seg_steps: int) -> jax.Array:
    """Bit-identical to :func:`wave_run` but the settle scan is split into
    dispatches of at most ``seg_steps`` steps, each ended by a tiny scalar
    fetch, so that no single device dispatch holds the device for
    minutes. Two compiled programs total (full segment + remainder)."""
    from fdtd2d.ops.cplx import czeros

    n_main = bundle.n_main
    if seg_steps >= n_main:
        return wave_run(bundle, b_sub)
    # eager complex zeros_like is UNIMPLEMENTED on this backend (it
    # broadcasts a 0-d complex fill value) — build via lax.complex instead
    u = czeros(b_sub.shape, b_sub.dtype)
    uprev = u
    B, nr, nc = b_sub.shape
    zc = czeros((B, nr, 2 * bundle.t), b_sub.dtype)
    zr = czeros((B, 2 * bundle.t, nc), b_sub.dtype)
    psi = (zc, zr, zc, zr, zc, zr)
    k0 = 0
    while k0 < n_main:
        n = min(seg_steps, n_main - k0)
        # remainder segments reuse the seg_steps program when possible
        u, uprev, psi = _settle_segment(bundle, b_sub, u, uprev, psi,
                                        jnp.int32(k0), nsteps=n)
        # end the dispatch with a REAL scalar fetch: an eager complex
        # element read (u[0,0,0]) materializes a 0-d complex array, which
        # is UNIMPLEMENTED on this backend and poisons the process
        float(_fetch_real(u))
        k0 += n
    return _avg_run(bundle, b_sub, u, uprev, psi)


def build_wave_bundle(eps, mu, dx, dy, omega, *, pml_thickness: int = 40,
                      sigma_max: float = 2.0, m: int = 3,
                      transits: float = 2.5, safety: float = 0.9,
                      stab_damp: float = 5e-4,
                      steps_override: Optional[int] = None) -> WaveBundle:
    """Host-side setup: coefficients, CFL step, dispersion-corrected drive,
    frequency-locked filter parameters.

    ``transits``: settling time in units of one straight-line domain
    transit at the fastest material speed — the knob trading per-
    application quality (outer refinement rounds) against cost.
    """
    eps = np.asarray(eps, np.float64)
    mu_np = np.asarray(mu, np.float64)
    Nx, Ny = eps.shape
    if Nx % 2 or Ny % 2:
        raise ValueError(f"even grid required, got {(Nx, Ny)}")
    im = 1.0 / mu_np
    ac2 = (1.0 / (2.0 * dx)) ** 2
    ar2 = (1.0 / (2.0 * dy)) ** 2

    # real per-axis stencils (the inv_s = 1 specialization of
    # fdfd/direct.py:five_point_coefficients, same edge truncation)
    e = np.zeros_like(im)
    w = np.zeros_like(im)
    s = np.zeros_like(im)
    n = np.zeros_like(im)
    e[:, : Ny - 2] = -ac2 * im[:, 1 : Ny - 1]
    w[:, 2:] = -ac2 * im[:, 1 : Ny - 1]
    s[: Nx - 2, :] = -ar2 * im[1 : Nx - 1, :]
    n[2:, :] = -ar2 * im[1 : Nx - 1, :]
    im_cm = np.pad(im[:, :-1], ((0, 0), (1, 0)))
    im_cp = np.pad(im[:, 1:], ((0, 0), (0, 1)))
    im_rm = np.pad(im[:-1, :], ((1, 0), (0, 0)))
    im_rp = np.pad(im[1:, :], ((0, 1), (0, 0)))
    dc = ac2 * (im_cm + im_cp)
    dr = ar2 * (im_rm + im_rp)

    # explicit-leapfrog CFL from the Gershgorin bound on eps^{-1} L_R
    gersh = np.max((dc + dr + np.abs(e) + np.abs(w) + np.abs(s) + np.abs(n))
                   / eps)
    dt = 2.0 * safety / math.sqrt(gersh)
    x = float(omega) * dt / 2.0
    if x >= 1.0:
        raise ValueError("omega beyond the leapfrog Nyquist at CFL dt")
    theta = 2.0 * math.asin(x)          # exact discrete-dispersion match
    period = max(int(round(2.0 * math.pi / theta)), 4)

    c_max = 1.0 / math.sqrt(eps.min() * mu_np.min())
    span = max(Nx * dx, Ny * dy)
    n_transit = span / (c_max * dt)
    n_ramp = 2 * period
    n_main = (int(steps_override) if steps_override is not None
              else int(math.ceil(transits * n_transit)) + n_ramp)

    # trapezoidal one-pole filters, passive and exact at the drive (module
    # docstring): h = sigma dt / (2 eps0 cos(theta/2)) per cell
    t_full = max(pml_thickness, 2)
    # strips must not overlap: clamp to a sublattice half-extent
    t_sub = max(min(t_full // 2, Nx // 4, Ny // 4), 1)
    sig_r = pml_sigma_profile(Nx, pml_thickness, sigma_max, m)
    sig_c = pml_sigma_profile(Ny, pml_thickness, sigma_max, m)

    def filt(sig):
        h = sig * dt / (2.0 * constants.EPSILON_0 * math.cos(theta / 2.0))
        return (1.0 - h) / (1.0 + h), -h / (1.0 + h)

    d0_r, gg_r = filt(sig_r)
    d0_c, gg_c = filt(sig_c)
    # band stabilizer half-damping (see WaveBundle.hd_r): flat over the
    # sigma-active cells, ~3x margin over the measured 1.6e-4/step growth
    hd_row = np.where(sig_r > 0, stab_damp, 0.0)
    hd_col = np.where(sig_c > 0, stab_damp, 0.0)

    def pack_col(prof, parities):
        # (Ny,) profile -> (4, 1, 2t) strip-packed per sublattice parity
        out = np.stack([np.concatenate([prof[p::2][:t_sub],
                                        prof[p::2][-t_sub:]])
                        for p in parities])
        return out[:, None, :]

    def pack_row(prof, parities):
        out = np.stack([np.concatenate([prof[p::2][:t_sub],
                                        prof[p::2][-t_sub:]])
                        for p in parities])
        return out[:, :, None]

    col_par = (0, 1, 0, 1)   # py per _PARITIES
    row_par = (0, 0, 1, 1)   # px per _PARITIES

    f32 = lambda arr: jnp.asarray(_sub_stack(arr), jnp.float32)
    common = dict(
        inv_eps_dt2=f32(dt * dt / eps),
        d0_col=jnp.asarray(pack_col(d0_c, col_par), jnp.float32),
        gg_col=jnp.asarray(pack_col(gg_c, col_par), jnp.float32),
        d0_row=jnp.asarray(pack_row(d0_r, row_par), jnp.float32),
        gg_row=jnp.asarray(pack_row(gg_r, row_par), jnp.float32),
        hd_r=jnp.asarray(np.stack([hd_row[p::2] for p in row_par]),
                         jnp.float32),
        hd_c=jnp.asarray(np.stack([hd_col[p::2] for p in col_par]),
                         jnp.float32),
        theta=jnp.asarray(theta, jnp.float32),
        t=t_sub, n_main=n_main, n_avg=period, n_ramp=n_ramp,
    )

    if np.ptp(mu_np) == 0.0:
        # constant mu: per-axis coefficients depend on one index only
        im0 = float(im.flat[0])
        e_c = np.full(Ny, -ac2 * im0)
        e_c[Ny - 2 :] = 0.0
        w_c = np.full(Ny, -ac2 * im0)
        w_c[:2] = 0.0
        s_v = np.full(Nx, -ar2 * im0)
        s_v[Nx - 2 :] = 0.0
        n_v = np.full(Nx, -ar2 * im0)
        n_v[:2] = 0.0
        dc_v = ac2 * im0 * (2.0 - (np.arange(Ny) == 0)
                            - (np.arange(Ny) == Ny - 1))
        dr_v = ar2 * im0 * (2.0 - (np.arange(Nx) == 0)
                            - (np.arange(Nx) == Nx - 1))
        vr = lambda prof: jnp.asarray(
            np.stack([prof[p::2] for p in row_par]), jnp.float32)
        vc = lambda prof: jnp.asarray(
            np.stack([prof[p::2] for p in col_par]), jnp.float32)
        return WaveBundle(
            dc=vc(dc_v), dr=vr(dr_v), e_c=vc(e_c), w_c=vc(w_c),
            s_r=vr(s_v), n_r=vr(n_v), dense=False, **common)

    return WaveBundle(dc=f32(dc), dr=f32(dr), e_c=f32(e), w_c=f32(w),
                      s_r=f32(s), n_r=f32(n), dense=True, **common)


# ---------------------------------------------------------------------------
# Full-grid assembly and the solver
# ---------------------------------------------------------------------------


@jax.jit
def _split_sub(b: jax.Array) -> jax.Array:
    return jnp.stack([b[px::2, py::2] for (px, py) in _PARITIES])


@jax.jit
def _merge_sub(x_sub: jax.Array, like: jax.Array) -> jax.Array:
    out = jnp.zeros_like(like)
    for i, (px, py) in enumerate(_PARITIES):
        out = out.at[px::2, py::2].set(x_sub[i])
    return out


@jax.jit
def _precondition_full(bundle: WaveBundle, b: jax.Array) -> jax.Array:
    """Wave-run approximate inverse on the full grid. The bundle is a jit
    ARGUMENT (never a closure constant): closure constants are inlined
    into the program as HLO literals."""
    return _merge_sub(wave_run(bundle, _split_sub(b)), b)


class TimeDomainSolver:
    """Build-once / solve-many wavelength-robust solver (no stored factors).

    Memory: a handful of (Nx/2, Ny/2) arrays plus thin filter strips — no
    factor-memory wall; 4096^2 fits one chip with room to spare. Same
    ``solve`` contract as :class:`fdtd2d.fdfd.direct.DirectSolver`:
    returns ``(field, trace)`` with TRUE f64 residuals per refinement
    round.
    """

    # per-dispatch budget in CELL-steps: 6e10 cell-steps per dispatch (its
    # duration on this card is not measured; ROADMAP C5 decides whether
    # the chunking stays).
    DISPATCH_CELL_STEPS = 6e10

    def __init__(self, eps, mu, dx, dy, omega, *, pml_thickness: int = 40,
                 sigma_max: float = 2.0, m: int = 3, transits: float = 2.5,
                 dtype=jnp.complex64, steps_override: Optional[int] = None,
                 max_dispatch_steps: Optional[int] = None):
        from fdtd2d.ops.helmholtz import make_operator
        from fdtd2d.ops.splitc import make_operator_f64

        self.omega = float(omega)
        self.dtype = dtype
        self.bundle = build_wave_bundle(
            eps, mu, dx, dy, self.omega, pml_thickness=pml_thickness,
            sigma_max=sigma_max, m=m, transits=transits,
            steps_override=steps_override)
        self.op = make_operator(eps, mu, dx, dy, self.omega,
                                pml_thickness, sigma_max, m, dtype)
        self.op64 = make_operator_f64(np.asarray(eps), np.asarray(mu), dx, dy,
                                      self.omega, pml_thickness, sigma_max, m)
        self.steps_per_apply = self.bundle.n_main + self.bundle.n_avg
        if max_dispatch_steps is None:
            cells = int(np.asarray(eps).size)
            max_dispatch_steps = max(int(self.DISPATCH_CELL_STEPS // cells),
                                     256)
        self.max_dispatch_steps = int(max_dispatch_steps)

    def precondition(self, b: jax.Array) -> jax.Array:
        """~A^{-1} b on the full grid (complex64 in, complex64 out).

        Splits the settle scan into <=``max_dispatch_steps``-step
        dispatches (single-dispatch when it fits) — see
        :func:`wave_run_chunked`."""
        if self.bundle.n_main <= self.max_dispatch_steps:
            return _precondition_full(self.bundle, b)
        x_sub = wave_run_chunked(self.bundle, _split_sub(b),
                                 self.max_dispatch_steps)
        return _merge_sub(x_sub, b)

    def solve(self, source, *, rhs_scale=None, refine_target: float = 1e-6,
              max_refine_rounds: int = 30, return_split: bool = False,
              verbose: bool = False):
        from fdtd2d.fdfd.refine import refine, true_relative_residual
        from fdtd2d.ops.splitc import split_from_numpy, split_to_complex

        scale = (-1j * self.omega) if rhs_scale is None else complex(rhs_scale)
        b64 = split_from_numpy(np.asarray(source, np.complex128) * scale)
        out = refine(self.op64, b64, self.precondition,
                     target=refine_target, max_rounds=max_refine_rounds,
                     inner_dtype=self.dtype)
        if float(out.relative_residual) > refine_target:
            import warnings

            warnings.warn(
                f"time-domain solve stalled at true residual "
                f"{float(out.relative_residual):.2e} (target "
                f"{refine_target:.0e}); trapped/resonant media may need more "
                f"transits (currently {self.bundle.n_main} settle steps) or "
                f"the direct solver", RuntimeWarning, stacklevel=2)
        if verbose:
            print(f"timedomain: true res={float(out.relative_residual):.3e} "
                  f"rounds={out.rounds} steps/apply={self.steps_per_apply}")
        if return_split:
            return out.x, out.trace
        xc = split_to_complex(out.x, self.dtype)
        return xc, list(out.trace) + [true_relative_residual(
            self.op64, b64, xc)]
