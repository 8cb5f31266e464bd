"""Diagnose the trained diffusion surrogate: where does the chain lose the scene?

Probes, per timestep t:
  - eps-prediction MSE (the training objective, unweighted)
  - corr(x0_hat, x0) where x0_hat = (x_t - sqrt(1-ab) eps_hat)/sqrt(ab)
    (does a SINGLE model call recover the field structure at this noise level?)
  - conditioning sensitivity: same x_t, scene swapped -> relative output change
on TRAIN samples vs HOLDOUT samples (memorization vs generalization), plus an
in-sample full-chain generation corr.

Usage: python examples/surrogate_diagnose.py [ckpt_dir] [data.npz]
"""
import sys

import numpy as np

from fdtd2d.utils.cache import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp

from fdtd2d.models.train import (
    TrainConfig, create_state, restore_checkpoint, compute_scales_host,
    inference)
from fdtd2d.models.diffusion import DDPMSchedule

ckpt_dir = sys.argv[1] if len(sys.argv) > 1 else "runs/ckpt10k_shape"
data_path = sys.argv[2] if len(sys.argv) > 2 else "runs/data10k_shape.npz"

z = np.load(data_path)
n = z["Ez"].shape[0]
H, W = z["Ez"].shape[1:]
config = TrainConfig()
state = create_state(jax.random.PRNGKey(0), (H, W), config)
state, next_epoch, scales = restore_checkpoint(ckpt_dir, state)
print(f"restored epoch {next_epoch - 1}; scales:",
      {k: float(v) for k, v in scales.items()} if scales else None)
schedule = DDPMSchedule.create(config.num_train_timesteps)

if scales is None:
    scales = compute_scales_host({k: z[k] for k in ("eps", "mu", "src", "omega", "Ez")})
scales = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), scales)

# train samples = first 8; holdout = last 8 (train used holdout=64 at the tail)
idx_train = np.arange(8)
idx_hold = np.arange(n - 8, n)


def norm_batch(idx):
    return {
        "eps": jnp.asarray(z["eps"][idx], jnp.float32) / scales["eps"],
        "mu": jnp.asarray(z["mu"][idx], jnp.float32) / scales["mu"],
        "src": jnp.asarray(z["src"][idx], jnp.float32),
        "omega": jnp.asarray(z["omega"][idx], jnp.float32).reshape(-1) / scales["omega"],
        "Ez": jnp.asarray(z["Ez"][idx], jnp.float32) / scales["Ez"],
    }


@jax.jit
def probe(batch, t, key):
    x0 = batch["Ez"]
    B = x0.shape[0]
    eps_noise = jax.random.normal(key, x0.shape, x0.dtype)
    tb = jnp.full((B,), t)
    ab = schedule.alphas_cumprod[t]
    xt = jnp.sqrt(ab) * x0 + jnp.sqrt(1 - ab) * eps_noise
    pred = state.apply_fn(
        {"params": state.params, "batch_stats": state.batch_stats},
        batch["eps"], batch["mu"], batch["src"], xt, tb, batch["omega"],
        train=False)
    mse = jnp.mean((pred - eps_noise) ** 2, axis=(1, 2))
    x0_hat = (xt - jnp.sqrt(1 - ab) * pred) / jnp.sqrt(ab)

    def corr(a, b):
        a = a - a.mean()
        b = b - b.mean()
        return jnp.sum(a * b) / (jnp.linalg.norm(a) * jnp.linalg.norm(b) + 1e-30)

    c = jax.vmap(corr)(x0_hat, x0)
    # conditioning sensitivity: roll the scene channels by one sample,
    # keep x_t fixed
    pred_swap = state.apply_fn(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.roll(batch["eps"], 1, 0), jnp.roll(batch["mu"], 1, 0),
        jnp.roll(batch["src"], 1, 0), xt, tb, jnp.roll(batch["omega"], 1, 0),
        train=False)
    sens = (jnp.linalg.norm((pred_swap - pred).reshape(B, -1), axis=1)
            / (jnp.linalg.norm(pred.reshape(B, -1), axis=1) + 1e-30))
    return mse, c, sens


key = jax.random.PRNGKey(42)
ts = [5, 20, 50, 100, 200, 400, 600, 800, 950, 995]
for name, idx in (("TRAIN", idx_train), ("HOLDOUT", idx_hold)):
    batch = norm_batch(idx)
    print(f"--- {name} ---")
    print(f"{'t':>5} {'eps-MSE':>9} {'corr(x0_hat,x0)':>16} {'cond-sens':>10}")
    for t in ts:
        key, k = jax.random.split(key)
        mse, c, sens = probe(batch, t, k)
        print(f"{t:>5} {float(jnp.mean(mse)):>9.4f} "
              f"{float(jnp.mean(c)):>16.4f} {float(jnp.mean(sens)):>10.4f}")

# full-chain generation, in-sample (the reference's own eval protocol)
for name, idx in (("TRAIN", idx_train), ("HOLDOUT", idx_hold)):
    batch = norm_batch(idx)
    key, k = jax.random.split(key)
    pred = inference(state, schedule, k,
                     jnp.asarray(z["eps"][idx], jnp.float32),
                     jnp.asarray(z["mu"][idx], jnp.float32),
                     jnp.asarray(z["src"][idx], jnp.float32),
                     jnp.asarray(z["omega"][idx], jnp.float32).reshape(-1),
                     scales=scales, stochastic=False)
    pred = np.asarray(pred)
    true = np.asarray(z["Ez"][idx])
    cs = []
    for p, tr in zip(pred, true):
        p = p - p.mean(); tr = tr - tr.mean()
        cs.append(float(np.sum(p * tr) /
                        (np.linalg.norm(p) * np.linalg.norm(tr) + 1e-30)))
    print(f"{name} full-chain (deterministic) corr: "
          f"mean {np.mean(cs):.4f} per-sample {[f'{c:.3f}' for c in cs]}")
