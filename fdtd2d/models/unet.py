"""UNet for the diffusion surrogate, in plain JAX.

Architecture-equivalent of the reference's PyTorch model (reference:
python-src/diffusion_model.py:35-132): 3-level encoder 4->64->128->256 with
512-channel bottleneck, double Conv3x3+BatchNorm+ReLU blocks, sinusoidal
time embedding injected at the bottleneck only, per-scale omega-embedding
MLPs added after each max-pool, nearest-neighbor-upsample decoder with skip
concatenation, 1x1 conv head predicting noise.

Laid out NHWC; inputs are the stacked physical channels (eps, mu, src,
noisy_Ez) as (B, H, W, 4). Parameters and BatchNorm statistics are nested
dicts (``{"params": ..., "batch_stats": ...}``); :meth:`UNet2D.init` and
:meth:`UNet2D.apply` follow the usual ``init``/``apply`` calling convention
(``mutable=["batch_stats"]`` returns the updated statistics in training).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp

_BN_MOMENTUM = 0.99
_BN_EPS = 1e-5
_init = jax.nn.initializers.lecun_normal()


def sinusoidal_embedding(t: jax.Array, dim: int) -> jax.Array:
    """Reference SinusoidalPosEmb (diffusion_model.py:7-21): [B] -> [B, dim]."""
    half = dim // 2
    freqs = jnp.exp(-jnp.log(10000.0) * jnp.arange(half) / (half - 1))
    args = t.astype(jnp.float32)[:, None] * freqs[None, :]
    return jnp.concatenate([jnp.sin(args), jnp.cos(args)], axis=-1)


# -- layers: (init, apply) pairs over plain dicts -----------------------------


def _dense_init(key, fin, fout):
    return {"kernel": _init(key, (fin, fout), jnp.float32),
            "bias": jnp.zeros((fout,), jnp.float32)}


def _dense(p, x, dtype):
    return x.astype(dtype) @ p["kernel"].astype(dtype) + p["bias"].astype(dtype)


def _conv_init(key, k, fin, fout):
    return {"kernel": _init(key, (k, k, fin, fout), jnp.float32),
            "bias": jnp.zeros((fout,), jnp.float32)}


def _conv(p, x, dtype):
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + p["bias"].astype(dtype)


def _bn_init(c):
    return ({"scale": jnp.ones((c,), jnp.float32),
             "bias": jnp.zeros((c,), jnp.float32)},
            {"mean": jnp.zeros((c,), jnp.float32),
             "var": jnp.ones((c,), jnp.float32)})


def _batch_norm(p, stats, x, train, dtype):
    """BatchNorm over (B, H, W) with statistics in float32 whatever the
    compute dtype; returns (y, new_stats)."""
    xf = x.astype(jnp.float32)
    if train:
        mean = jnp.mean(xf, axis=(0, 1, 2))
        var = jnp.mean(jnp.square(xf - mean), axis=(0, 1, 2))
        stats = {"mean": _BN_MOMENTUM * stats["mean"] + (1 - _BN_MOMENTUM) * mean,
                 "var": _BN_MOMENTUM * stats["var"] + (1 - _BN_MOMENTUM) * var}
    else:
        mean, var = stats["mean"], stats["var"]
    y = (xf - mean) * jax.lax.rsqrt(var + _BN_EPS) * p["scale"] + p["bias"]
    return y.astype(dtype), stats


def _block_init(key, fin, fout):
    """Conv3x3 + BatchNorm + ReLU, twice (reference make_block, :24-32)."""
    k0, k1 = jax.random.split(key)
    bn_p, bn_s = _bn_init(fout)
    params = {"Conv_0": _conv_init(k0, 3, fin, fout), "BatchNorm_0": bn_p,
              "Conv_1": _conv_init(k1, 3, fout, fout), "BatchNorm_1": bn_p}
    return params, {"BatchNorm_0": bn_s, "BatchNorm_1": bn_s}


def _block(p, s, x, train, dtype):
    new = {}
    for i in range(2):
        x = _conv(p[f"Conv_{i}"], x, dtype)
        x, new[f"BatchNorm_{i}"] = _batch_norm(
            p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"], x, train, dtype)
        x = jax.nn.relu(x)
    return x, new


def _omega_init(key, c):
    """Per-scale omega embedding: Linear(1,C) -> ReLU -> Linear(C,C)."""
    k0, k1 = jax.random.split(key)
    return {"Dense_0": _dense_init(k0, 1, c), "Dense_1": _dense_init(k1, c, c)}


def _omega(p, omega, dtype):
    h = jax.nn.relu(_dense(p["Dense_0"], omega[:, None], dtype))
    return _dense(p["Dense_1"], h, dtype)


def _max_pool(x):
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "VALID")


@dataclasses.dataclass(frozen=True)
class UNet2D:
    time_embed_dim: int = 512
    channels: Sequence[int] = (64, 128, 256)
    bottleneck: int = 512
    # compute dtype for the conv/dense math. jnp.bfloat16 runs them on the
    # bf16 tensor cores while master params, BatchNorm statistics, the 1x1
    # head, and the loss stay float32 (standard mixed precision).
    dtype: Any = jnp.float32

    def _blocks(self):
        """(name, in, out) of the conv blocks in call order."""
        c1, c2, c3 = self.channels
        b = self.bottleneck
        return (("ConvBlock_0", 4, c1), ("ConvBlock_1", c1, c2),
                ("ConvBlock_2", c2, c3), ("ConvBlock_3", c3, b),
                ("ConvBlock_4", b + c3, c3), ("ConvBlock_5", c3 + c2, c2),
                ("ConvBlock_6", c2 + c1, c1))

    def init(self, key, *args, train: bool = False):
        """Fresh ``{"params", "batch_stats"}``. The call arguments are
        accepted for the init/apply convention only: every shape follows
        from the configuration."""
        del args, train
        keys = iter(jax.random.split(key, 13))
        params, stats = {}, {}
        for name, fin, fout in self._blocks():
            params[name], stats[name] = _block_init(next(keys), fin, fout)
        for i, c in enumerate(self.channels):
            params[f"OmegaMLP_{i}"] = _omega_init(next(keys), c)
        d = self.time_embed_dim
        params["Dense_0"] = _dense_init(next(keys), d, d)
        params["Dense_1"] = _dense_init(next(keys), d, d)
        params["Conv_0"] = _conv_init(next(keys), 1, self.channels[0], 1)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables, eps, mu, src, noisy, t, omega, *,
              train: bool = False, mutable=False):
        """All field inputs (B, H, W); t and omega (B,). Returns (B, H, W)
        in float32 regardless of the compute dtype, and with ``mutable``
        also ``{"batch_stats": updated}``."""
        p, s = variables["params"], variables["batch_stats"]
        dt = self.dtype
        new = {}

        def block(name, x):
            y, new[name] = _block(p[name], s[name], x, train, dt)
            return y

        x = jnp.stack([eps, mu, src, noisy], axis=-1).astype(dt)
        om = omega.astype(dt)
        e1 = block("ConvBlock_0", x)
        p1 = _max_pool(e1) + _omega(p["OmegaMLP_0"], om, dt)[:, None, None, :]
        e2 = block("ConvBlock_1", p1)
        p2 = _max_pool(e2) + _omega(p["OmegaMLP_1"], om, dt)[:, None, None, :]
        e3 = block("ConvBlock_2", p2)
        p3 = _max_pool(e3) + _omega(p["OmegaMLP_2"], om, dt)[:, None, None, :]

        b = block("ConvBlock_3", p3)
        temb = sinusoidal_embedding(t, self.time_embed_dim).astype(dt)
        temb = jax.nn.relu(_dense(p["Dense_0"], temb, dt))
        temb = _dense(p["Dense_1"], temb, dt)
        b = b + temb[:, None, None, :]

        def up_to(h, ref):
            return jax.image.resize(h, ref.shape[:3] + (h.shape[-1],), "nearest")

        d3 = block("ConvBlock_4", jnp.concatenate([up_to(b, e3), e3], axis=-1))
        d2 = block("ConvBlock_5", jnp.concatenate([up_to(d3, e2), e2], axis=-1))
        d1 = block("ConvBlock_6", jnp.concatenate([up_to(d2, e1), e1], axis=-1))

        # head stays float32: the regression target spans orders of magnitude
        out = _conv(p["Conv_0"], d1.astype(jnp.float32), jnp.float32)[..., 0]
        if mutable:
            return out, {"batch_stats": new}
        return out
