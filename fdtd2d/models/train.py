"""Diffusion-surrogate training: jitted steps, checkpoint/RESUME, eval.

Reference training loop (python-src/diffusion_training.py:326-406): AdamW
lr 3e-5, batch 8, SNR^1.3 importance-sampled timesteps, SNR^5-weighted
noise-prediction MSE, per-epoch inference comparison, checkpoint every 10
epochs. The reference has NO resume path (SURVEY.md section 5); here
checkpoints are NumPy ``.npz`` files and ``restore`` round-trips the full
train state. Data-parallel scaling = shard the batch over a mesh ('dp') and
jit — gradients all-reduce between devices automatically.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from fdtd2d.models.unet import UNet2D
from fdtd2d.models.diffusion import (
    DDPMSchedule, snr_gamma_weight, importance_sample_timesteps, loss_weight,
    sample,
)


@partial(jax.tree_util.register_dataclass,
         data_fields=["step", "params", "opt_state", "batch_stats", "ema_params"],
         meta_fields=["apply_fn", "tx"])
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Parameters, optimizer state and BatchNorm statistics as one pytree;
    the model's ``apply`` and the optax transformation ride along as static
    metadata."""

    step: Any
    params: Any
    opt_state: Any
    batch_stats: dict
    apply_fn: Callable
    tx: optax.GradientTransformation
    # exponential moving average of params (None when EMA is off). Diffusion
    # quality is notoriously sensitive to late-training parameter noise; the
    # EMA iterate is the standard readout and directly targets the measured
    # run-to-run spread (0.25-0.53 ensemble correlation across seeds from
    # the same recipe).
    ema_params: Any = None

    @classmethod
    def create(cls, *, apply_fn, params, tx, **kwargs) -> "TrainState":
        return cls(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=tx.init(params), apply_fn=apply_fn, tx=tx,
                   **kwargs)

    def apply_gradients(self, *, grads) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(step=self.step + 1, opt_state=opt_state,
                            params=optax.apply_updates(self.params, updates))

    def replace(self, **kwargs) -> "TrainState":
        return dataclasses.replace(self, **kwargs)


def compute_scales(data: dict) -> dict:
    """Normalization constants for the physical channels (the reference feeds
    raw SI magnitudes — eps ~1e-11 — straight into convolutions; here inputs
    are scaled to O(1) and Ez labels to unit std, which the DDPM math
    assumes)."""
    return {
        "eps": jnp.mean(data["eps"]),
        "mu": jnp.mean(data["mu"]),
        "Ez": jnp.std(data["Ez"]) + 1e-30,
        "omega": jnp.asarray(1e10, data["omega"].dtype),
    }


def normalize(data: dict, scales: dict) -> dict:
    out = dict(data)
    for k in ("eps", "mu", "Ez", "omega"):
        if k in out:
            out[k] = out[k] / scales[k]
    return out


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-5
    batch_size: int = 8
    num_epochs: int = 100
    snr_weight_gamma: float = 5.0
    timestep_gamma: float = 1.3
    num_train_timesteps: int = 1000
    ckpt_every: int = 10
    ckpt_dir: Optional[str] = None
    # The reference's recipe is (epsilon, snr, snr_gamma) — kept as an
    # option, but it leaves t > ~500 untrained (see diffusion.loss_weight)
    # and cannot generate scene-locked fields from a full chain. The recipe
    # that works end-to-end is ("x0", "uniform", "uniform").
    # "regression" trains the same UNet as a plain supervised surrogate
    # (no noising, t pinned to 0, unweighted MSE): one forward pass at
    # inference instead of a 50-step chain — the deterministic
    # scene->field task's strongest single-call readout, a model family
    # the reference does not have.
    prediction_type: str = "epsilon"   # "epsilon" | "x0" | "regression"
    t_sampling: str = "snr"            # "snr" (SNR^1.3 importance) | "uniform"
    loss_weighting: str = "snr_gamma"  # "snr_gamma" | "min_snr" | "uniform"
    # 0.0 disables EMA; 0.999 is the conventional diffusion setting at this
    # step count. Eval/holdout/checkpoint-final readouts use the EMA iterate
    # when enabled (models/augment.py docstring for the motivation).
    ema_decay: float = 0.0
    # exact D4 scene/field augmentation (models/augment.py): up to 8x the
    # effective unique-scene count — the measured binding constraint on
    # surrogate quality — at zero datagen cost. Valid for square scenes.
    augment: bool = False
    # cap on train steps per device dispatch: epochs longer than this run
    # as equal chunks of one program each (identical shapes -> one
    # compile), each ended by a fetch, so that no single dispatch holds the
    # device for minutes; datasets small enough for one chunk keep the
    # exact single-dispatch key path. 1024 batch-8 256^2 steps per chunk.
    max_dispatch_steps: int = 1024
    # "bfloat16" runs the UNet's conv/dense math in bf16 on the tensor
    # cores while master params, BatchNorm statistics, the 1x1 head, the
    # loss, and the Adam state all stay float32 — standard mixed precision.
    # "float32" convolutions may run in TF32 on an NVIDIA GPU (XLA's default).
    compute_dtype: str = "float32"      # "float32" | "bfloat16"


def create_state(key, shape: Tuple[int, int], config: TrainConfig,
                 model: Optional[UNet2D] = None) -> TrainState:
    model = model or UNet2D(dtype=jnp.dtype(config.compute_dtype))
    H, W = shape
    dummy = jnp.zeros((1, H, W))
    variables = model.init(key, dummy, dummy, dummy, dummy,
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1,)), train=False)
    return TrainState.create(
        apply_fn=model.apply,
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        ema_params=(variables["params"] if config.ema_decay > 0 else None),
        tx=optax.adamw(config.lr),
    )


def ema_state(state: TrainState) -> TrainState:
    """The state to READ the model from: params swapped for their EMA when
    EMA is enabled (training always continues from the raw params)."""
    if state.ema_params is None:
        return state
    return state.replace(params=state.ema_params)


@partial(jax.jit, static_argnames=("snr_gamma", "t_gamma", "prediction_type",
                                   "t_sampling", "weighting", "ema_decay",
                                   "augment"))
def train_step(state: TrainState, schedule: DDPMSchedule, key, batch,
               snr_gamma: float = 5.0, t_gamma: float = 1.3,
               prediction_type: str = "epsilon", t_sampling: str = "snr",
               weighting: str = "snr_gamma", ema_decay: float = 0.0,
               augment: bool = False):
    """One weighted denoising step (reference :345-373 for the default
    epsilon/snr/snr_gamma recipe; see diffusion.loss_weight for why the
    x0/uniform/uniform recipe is the one that generates)."""
    k_t, k_noise, k_aug = jax.random.split(key, 3)
    if augment:
        from fdtd2d.models.augment import augment_batch

        batch = augment_batch(k_aug, batch)
    B = batch["Ez"].shape[0]
    if prediction_type == "regression":
        # plain supervised surrogate: no noising, t pinned to 0, plain MSE
        t = jnp.zeros((B,), jnp.int32)
        noisy = jnp.zeros_like(batch["Ez"])
        target = batch["Ez"]
    else:
        if t_sampling == "uniform":
            t = jax.random.randint(k_t, (B,), 0, schedule.num_timesteps)
        else:
            t = importance_sample_timesteps(schedule, k_t, B, gamma=t_gamma)
        noise = jax.random.normal(k_noise, batch["Ez"].shape,
                                  batch["Ez"].dtype)
        noisy = schedule.add_noise(batch["Ez"], noise, t)
        target = batch["Ez"] if prediction_type == "x0" else noise

    def loss_fn(params):
        pred, updates = state.apply_fn(
            {"params": params, "batch_stats": state.batch_stats},
            batch["eps"], batch["mu"], batch["src"], noisy,
            t, batch["omega"], train=True, mutable=["batch_stats"],
        )
        if prediction_type == "regression":
            w = 1.0
        else:
            w = loss_weight(schedule, t, weighting, prediction_type,
                            gamma=snr_gamma)
        per_sample = jnp.mean((pred - target) ** 2, axis=(1, 2))
        # pin the loss scalar to f32: under the x64-enabled CPU test mesh
        # f64 targets/schedule weights would upcast it (the mixed-precision
        # contract keeps master params, stats, and the LOSS in float32)
        return jnp.mean(w * per_sample).astype(jnp.float32), updates["batch_stats"]

    (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    state = state.apply_gradients(grads=grads)
    state = state.replace(batch_stats=new_stats)
    if ema_decay > 0 and state.ema_params is not None:
        # decay warmup (the standard EMA bias fix): the EMA is seeded at the
        # random init, so a flat decay of 0.999 leaves the first ~2-3k steps
        # of readouts dominated by init noise. min(decay, (1+t)/(10+t))
        # makes the early EMA a plain running mean and converges to the
        # configured decay once t >> 10/(1-decay) matters.
        step = state.step.astype(jnp.float32)
        eff = jnp.minimum(ema_decay, (1.0 + step) / (10.0 + step))
        state = state.replace(ema_params=jax.tree.map(
            lambda e, p: eff * e + (1.0 - eff) * p,
            state.ema_params, state.params))
    return state, loss


@partial(jax.jit, static_argnames=("batch_size", "snr_gamma", "t_gamma",
                                   "prediction_type", "t_sampling",
                                   "weighting", "ema_decay", "augment"))
def train_epoch(state: TrainState, schedule: DDPMSchedule, key, data: dict,
                perm, *, batch_size: int, snr_gamma: float = 5.0,
                t_gamma: float = 1.3, prediction_type: str = "epsilon",
                t_sampling: str = "snr", weighting: str = "snr_gamma",
                ema_decay: float = 0.0, augment: bool = False,
                affine: Optional[dict] = None, const: Optional[dict] = None):
    """One full epoch as a single device program (lax.scan over batches) —
    per-batch host dispatch would otherwise dominate wall-clock.

    The tail partial batch is dropped (the reference's DataLoader trains on
    it, drop_last=False); a shuffled-each-epoch tail loses < batch_size
    samples per epoch, different ones every time."""
    n = perm.shape[0]
    if batch_size > n:
        raise ValueError(
            f"batch_size={batch_size} exceeds dataset size {n}; an epoch "
            "would contain zero batches (mean over zero losses is NaN)")
    nb = n // batch_size
    affine = affine or {}
    const = const or {}
    hw = data["Ez"].shape[1:]

    def body(carry, k):
        state, key = carry
        key, k_step = jax.random.split(key)
        idx = jax.lax.dynamic_slice(perm, (k * batch_size,), (batch_size,))
        # astype: data may live on device in float16 or uint8 (the compact
        # cache for datasets near HBM capacity); the model runs f32.
        # ``affine`` decodes binary uint8 masks back to their two values;
        # ``const`` materializes constant channels (e.g. uniform mu) that
        # are not stored at all.
        batch = {name: v[idx].astype(jnp.float32) for name, v in data.items()
                 if name not in ("eps_bits", "src_box")}
        if "eps_bits" in data:
            # bit-packed binary eps mask (np.packbits, big-endian: first
            # pixel in the MSB); unpacked per batch with shifts — 1/8 the
            # HBM of a uint8 mask. ``affine`` then maps 0/1 -> EPS_LO/HI.
            bits = data["eps_bits"][idx]                      # (B,H,W//8) u8
            shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)   # MSB first
            px = (bits[..., None] >> shifts) & jnp.uint8(1)
            batch["eps"] = px.reshape((batch_size,) + hw).astype(jnp.float32)
        if "src_box" in data:
            # the datagen sources are axis-aligned segments or points
            # (datagen.random_source), so an inclusive bounding box
            # (r0, r1, c0, c1) IS the mask — 8 B/scene instead of H*W.
            box = data["src_box"][idx].astype(jnp.int32)      # (B, 4)
            rows = jax.lax.broadcasted_iota(jnp.int32, (batch_size,) + hw, 1)
            cols = jax.lax.broadcasted_iota(jnp.int32, (batch_size,) + hw, 2)
            r0, r1, c0, c1 = (box[:, i, None, None] for i in range(4))
            batch["src"] = ((rows >= r0) & (rows <= r1) &
                            (cols >= c0) & (cols <= c1)).astype(jnp.float32)
        for name, (sc, off) in affine.items():
            batch[name] = batch[name] * sc + off
        for name, c in const.items():
            batch[name] = jnp.full((batch_size,) + hw, c, jnp.float32)
        state, loss = train_step(state, schedule, k_step, batch,
                                 snr_gamma=snr_gamma, t_gamma=t_gamma,
                                 prediction_type=prediction_type,
                                 t_sampling=t_sampling, weighting=weighting,
                                 ema_decay=ema_decay, augment=augment)
        return (state, key), loss

    (state, _), losses = jax.lax.scan(body, (state, key), jnp.arange(nb))
    return state, jnp.mean(losses)


def inference(state: TrainState, schedule: DDPMSchedule, key, eps, mu, src,
              omega, num_inference_steps: int = 50, scales: Optional[dict] = None,
              stochastic: bool = True, prediction_type: str = "epsilon",
              t_start: Optional[int] = None):
    """Denoise from pure noise (reference inference(), :283-323).

    With ``scales`` (from :func:`train`), physical inputs are normalized and
    the returned field is denormalized back to physical units.
    ``stochastic=False`` runs the deterministic (DDIM-like) chain — for a
    near-deterministic conditional task it reads out closer to the
    posterior mean than a stochastic sample.

    ``prediction_type="regression"`` checkpoints skip the chain entirely:
    one forward pass at t=0 on a zero field IS the model's prediction."""

    if scales is not None:
        eps = eps / scales["eps"]
        mu = mu / scales["mu"]
        omega = omega / scales["omega"]

    def apply_fn(eps, mu, src, x, t, om):
        return state.apply_fn(
            {"params": state.params, "batch_stats": state.batch_stats},
            eps, mu, src, x, t, om, train=False,
        )

    if prediction_type == "regression":
        out = apply_fn(eps, mu, src, jnp.zeros_like(eps),
                       jnp.zeros((eps.shape[0],), jnp.int32), omega)
    else:
        out = sample(schedule, apply_fn, key, eps, mu, src, omega,
                     num_inference_steps=num_inference_steps,
                     stochastic=stochastic, prediction_type=prediction_type,
                     t_start=t_start)
    if scales is not None:
        out = out * scales["Ez"]
    return out


def regress(state: TrainState, schedule: DDPMSchedule, key, eps, mu, src,
            omega, scales: Optional[dict] = None):
    """Single-call surrogate readout for x0-prediction models: evaluate the
    network once at t = T-1 on pure noise, returning its direct estimate of
    the clean field E[x0 | scene]. 50x cheaper than the DDPM chain (one UNet
    apply instead of num_inference_steps) and deterministic up to the noise
    draw's (negligible at t=T-1) influence — the "fast mode" the diffusion
    parameterization gives for free. Only meaningful for checkpoints trained
    with prediction_type="x0"."""
    if scales is not None:
        eps = eps / scales["eps"]
        mu = mu / scales["mu"]
        omega = omega / scales["omega"]
    x = jax.random.normal(key, eps.shape, eps.dtype)
    t = jnp.full((eps.shape[0],), schedule.num_timesteps - 1)
    out = state.apply_fn(
        {"params": state.params, "batch_stats": state.batch_stats},
        eps, mu, src, x, t, omega, train=False)
    if scales is not None:
        out = out * scales["Ez"]
    return out


def ensemble_inference(state: TrainState, schedule: DDPMSchedule, key, eps,
                       mu, src, omega, n_members: int = 8,
                       num_inference_steps: int = 50,
                       scales: Optional[dict] = None,
                       prediction_type: str = "epsilon",
                       chunk: int = 0):
    """Posterior-mean surrogate readout: the mean of ``n_members``
    independent stochastic DDPM chains. The conditional task is
    deterministic (scene -> one field), so the Bayes-optimal L2 readout is
    E[x0 | scene]; averaging samples cancels the per-chain sampling variance
    single-sample readouts carry. Measured on the 100-epoch x0-recipe run
    (64 holdouts): ensemble-8 Pearson corr 0.53 mean / 0.78 best vs 0.48
    for the deterministic 50-step chain and 0.44 for one stochastic chain.
    NOTE the posterior mean shrinks amplitude where the model is uncertain
    (~4x measured); calibrate with the best-fit scalar <pred,true>/<pred,pred>
    when an unbiased amplitude matters.

    ``chunk > 0`` slices the batch so only ``chunk`` samples' UNet
    activations are live at once (a full 64-sample batch at 256^2 costs
    several GB — same rationale as :func:`holdout_relative_l2`). Each
    chunk folds its offset into the member key, so chunks draw independent
    noise; chunked and unchunked results are therefore statistically
    equivalent but not bitwise equal."""
    B = eps.shape[0]
    out = None
    for _ in range(n_members):
        key, k = jax.random.split(key)
        if chunk and chunk < B:
            parts = []
            for c0 in range(0, B, chunk):
                sl = slice(c0, min(c0 + chunk, B))
                parts.append(inference(
                    state, schedule, jax.random.fold_in(k, c0), eps[sl],
                    mu[sl], src[sl], omega[sl],
                    num_inference_steps=num_inference_steps, scales=scales,
                    stochastic=True, prediction_type=prediction_type))
            member = jnp.concatenate(parts, axis=0)
        else:
            member = inference(state, schedule, k, eps, mu, src, omega,
                               num_inference_steps=num_inference_steps,
                               scales=scales, stochastic=True,
                               prediction_type=prediction_type)
        out = member if out is None else out + member
    return out / n_members


# ---------------------------------------------------------------------------
# Checkpointing (save AND restore — the reference only saves)
# ---------------------------------------------------------------------------


def _flatten(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in leaves}


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int,
                    scales: Optional[dict] = None) -> None:
    """Persist the train state PLUS the dataset normalization scales as
    ``<ckpt_dir>/epoch_<epoch>.npz`` (one array per pytree path).

    The scales are part of the model contract — inference must divide inputs
    and multiply outputs by the training-time constants (reference feeds raw
    SI units and has no such layer; an earlier revision here recomputed
    scales from whatever data was at hand, which silently changed the field
    scaling when inferring against different data)."""
    import os

    payload = {"params": state.params, "batch_stats": state.batch_stats,
               "opt_state": state.opt_state, "step": state.step, "epoch": epoch}
    if scales is not None:
        payload["scales"] = {k: jnp.asarray(v) for k, v in scales.items()}
    if state.ema_params is not None:
        payload["ema_params"] = state.ema_params
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"epoch_{epoch:05d}.npz")
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **_flatten(payload))
    os.replace(tmp, path)


def restore_checkpoint(ckpt_dir: str, state: TrainState):
    """Restore the latest checkpoint; returns (state, next_epoch, scales).

    ``scales`` is the training-time normalization dict (None for checkpoints
    written before scales were part of the payload — recompute those with
    :func:`compute_scales` on the original training data)."""
    import os
    import warnings

    if not os.path.isdir(ckpt_dir):
        return state, 0, None
    epochs = sorted(int(d[len("epoch_"):-len(".npz")]) for d in os.listdir(ckpt_dir)
                    if d.startswith("epoch_") and d.endswith(".npz")
                    and not d.endswith(".tmp.npz"))
    if not epochs:
        return state, 0, None
    epoch = epochs[-1]
    path = os.path.join(ckpt_dir, f"epoch_{epoch:05d}.npz")
    with np.load(path) as z:
        stored = dict(z)
    template = {"params": state.params, "batch_stats": state.batch_stats,
                "opt_state": state.opt_state, "step": state.step, "epoch": 0}

    # Both 'scales' and 'ema_params' are optional subtrees (older layouts
    # lack them; EMA is present only for runs with ema_decay > 0). Decide
    # which ones THIS checkpoint carries from its stored keys.
    top = {k[2 : k.index("']")] for k in stored}
    with_scales = "scales" in top
    with_ema = "ema_params" in top
    if not with_scales:
        warnings.warn(
            f"checkpoint {path} has no normalization scales (pre-scales "
            "format); inference against it must recompute scales from the "
            "ORIGINAL training data or fields will be mis-scaled",
            stacklevel=2)
    if not with_ema and state.ema_params is not None:
        warnings.warn(
            f"checkpoint {path} has no EMA params (pre-EMA format); "
            "re-seeding the EMA from the restored raw params", stacklevel=2)
    t = dict(template)
    if with_scales:
        t["scales"] = {k: jnp.zeros(()) for k in ("eps", "mu", "Ez", "omega")}
    if with_ema:
        # restore the stored EMA even for EMA-unaware callers (the
        # `fdtd2d infer` path, default config) so readouts use the EMA
        # iterate
        t["ema_params"] = (state.ema_params if state.ema_params is not None
                           else state.params)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(t)
    payload = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(stored[jax.tree_util.keystr(k)]) for k, _ in leaves])
    scales = payload["scales"] if with_scales else None
    ema = None
    if with_ema:
        ema = payload["ema_params"]
    elif state.ema_params is not None:
        ema = payload["params"]
    state = state.replace(params=payload["params"],
                          batch_stats=payload["batch_stats"],
                          opt_state=payload["opt_state"], step=payload["step"],
                          ema_params=ema)
    return state, epoch + 1, scales


def compute_scales_host(data: dict) -> dict:
    """:func:`compute_scales` on host numpy arrays (streaming datasets that
    must not be materialized on device). Scales keep each array's dtype —
    numpy reductions return float64 scalars, which would silently promote
    every streamed batch (and the batch_stats) to f64 under x64."""
    def s(key, stat):
        v = np.asarray(data[key])
        return jnp.asarray(np.asarray(stat(v), v.dtype))

    return {
        "eps": s("eps", np.mean),
        "mu": s("mu", np.mean),
        "Ez": s("Ez", lambda a: np.std(a) + 1e-30),
        "omega": jnp.asarray(
            np.asarray(1e10, np.asarray(data["omega"]).dtype)),
    }


def holdout_relative_l2(state: TrainState, schedule: DDPMSchedule, key,
                        holdout: dict, scales: dict,
                        num_inference_steps: int = 50,
                        chunk: int = 8,
                        prediction_type: str = "epsilon") -> np.ndarray:
    """Per-sample relative L2 of DDPM-predicted vs true Ez on a holdout
    batch (physical units) — the quantitative surrogate metric the
    reference never reports (it eyeballs per-epoch panels,
    diffusion_training.py:382-394). Inference runs in ``chunk``-sized
    slices: a full-holdout UNet batch at 256^2 costs several GB of
    activations, which must not evict a device-resident dataset."""
    n = np.asarray(holdout["Ez"]).shape[0]
    preds = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        key, k = jax.random.split(key)
        preds.append(np.asarray(inference(
            state, schedule, k,
            jnp.asarray(np.asarray(holdout["eps"][sl]), jnp.float32),
            jnp.asarray(np.asarray(holdout["mu"][sl]), jnp.float32),
            jnp.asarray(np.asarray(holdout["src"][sl]), jnp.float32),
            jnp.asarray(np.asarray(holdout["omega"][sl]),
                        jnp.float32).reshape(-1),
            num_inference_steps=num_inference_steps, scales=scales,
            prediction_type=prediction_type)))
    pred = np.concatenate(preds)
    true = np.asarray(holdout["Ez"])
    num = np.linalg.norm((pred - true).reshape(len(true), -1), axis=1)
    den = np.linalg.norm(true.reshape(len(true), -1), axis=1) + 1e-30
    return num / den


def train(key, data: dict, config: TrainConfig,
          state: Optional[TrainState] = None, eval_every: int = 0,
          eval_callback=None, callback=None, stream_chunk: int = 0,
          holdout: int = 0, holdout_callback=None,
          device_dtype=None):
    """Epoch loop over a dataset dict (eps/mu/src/omega/Ez).

    Resumes from ``config.ckpt_dir`` if checkpoints exist there (including
    the persisted normalization scales, so resumed runs and later inference
    never depend on recomputing statistics from the original data).

    ``eval_every``/``eval_callback``: every N epochs run full DDPM inference
    on one sample and call
    ``eval_callback(epoch, predicted_field, true_field)`` with PHYSICAL-unit
    (denormalized) arrays — the reference's per-epoch comparison panel
    (reference: python-src/diffusion_training.py:382-394).

    ``holdout``: withhold the LAST ``holdout`` samples from training; every
    ``eval_every`` epochs compute the per-sample relative L2 of predicted vs
    true Ez over them (:func:`holdout_relative_l2`) and call
    ``holdout_callback(epoch, rel_l2_per_sample)``. The eval panel then
    shows holdout sample 0 (a field the model never trained on).

    ``stream_chunk``: 0 keeps the whole dataset on device and scans each
    epoch in one program. A positive value (a multiple of batch_size) keeps
    ``data`` on the HOST (pass numpy arrays) and streams shuffled chunks of
    that many samples per dispatch — the path for datasets past HBM (e.g.
    10k scenes at 250^2: ~12 GB). A ragged tail chunk is dropped each epoch
    (different samples every epoch under the shuffle).

    ``device_dtype`` (non-stream path only): store the normalized eps/mu/src
    INPUT channels on device in this dtype (e.g. ``jnp.float16``, exact for
    the binary/mask channels) while Ez labels stay f32 — a 2x device-memory
    cut that fits the 10k x 256^2 dataset in HBM, so epochs run at pure
    compute speed instead of re-streaming ~13 GB from the host every
    epoch.

    ``device_dtype="compact"``: the 4-bytes-per-pixel HBM cache for the
    datagen distribution (reference python-src/diffusion_training.py:54-146
    draws binary eps, a 0/1 src mask, constant mu). ``data`` must be the
    RAW compact dict from ``load_dataset(path, decode=False)``
    (eps_mask/src_mask uint8, omega/Ez float32). On device: eps/src stay
    uint8, Ez is stored float16-normalized (unit std; |values| ~O(1), well
    inside f16 range), mu is never stored — train_epoch decodes masks with
    a per-channel affine and materializes mu per batch. 50k scenes at 256²
    = ~13.4 GB resident, where the f32/f16 paths need
    52/33 GB — the difference between compute-speed epochs and
    re-streaming the dataset every epoch.
    """
    schedule = DDPMSchedule.create(config.num_train_timesteps)
    shape = data["Ez"].shape[1:]
    key, k_init = jax.random.split(key)
    if state is None:
        state = create_state(k_init, shape, config)
    start_epoch = 0
    ckpt_scales = None
    if config.ckpt_dir:
        state, start_epoch, ckpt_scales = restore_checkpoint(config.ckpt_dir, state)
        if config.ema_decay == 0 and state.ema_params is not None:
            # resuming TRAINING from an EMA checkpoint without --ema-decay:
            # train_step would never update the restored EMA, yet every
            # eval/holdout/final readout reads through ema_state(state) —
            # metrics would silently track the stale old-run average while
            # the raw params train on. Drop it; the forced-EMA restore is
            # for the read-only infer path (which calls restore_checkpoint
            # directly), not for resumed training.
            import warnings

            warnings.warn(
                "resuming with ema_decay=0 from a checkpoint that carries "
                "EMA params: discarding the stored EMA so readouts follow "
                "the training params (pass --ema-decay to keep updating it)",
                stacklevel=2)
            state = state.replace(ema_params=None)

    compact = isinstance(device_dtype, str) and device_dtype == "compact"
    raw = {k: v for k, v in data.items()
           if k not in ("residuals", "compact_version")}
    if compact and "eps_mask" not in raw:
        raise ValueError(
            'device_dtype="compact" needs the RAW compact dict — load with '
            "load_dataset(path, decode=False)")
    if compact and stream_chunk:
        raise ValueError("stream_chunk and the compact device cache are "
                         "alternatives; choose one")
    holdout_set = None
    if holdout > 0:
        if holdout >= data["Ez"].shape[0]:
            raise ValueError(f"holdout={holdout} swallows the whole dataset")
        holdout_set = {k: np.asarray(v[-holdout:]) for k, v in raw.items()}
        if "eps_mask" in holdout_set:
            from fdtd2d.models.datagen import _decode_compact

            holdout_set = _decode_compact(holdout_set)
        raw = {k: v[:-holdout] for k, v in raw.items()}
    n = raw["Ez"].shape[0]
    affine = const = None
    if stream_chunk:
        if stream_chunk % config.batch_size:
            raise ValueError(
                f"stream_chunk={stream_chunk} must be a multiple of "
                f"batch_size={config.batch_size}")
        if stream_chunk > n:
            # clamp to the largest whole-batch chunk: a chunk bigger than
            # the dataset would run ZERO chunks per epoch and report
            # np.mean([]) = NaN while training nothing
            stream_chunk = (n // config.batch_size) * config.batch_size
            if stream_chunk == 0:
                raise ValueError(
                    f"dataset size {n} is smaller than one batch "
                    f"({config.batch_size})")
        scales = ckpt_scales or compute_scales_host(raw)
        # f32 throughout the streamed path (model/optimizer are f32; any f64
        # leak via x64 promotion breaks the train_epoch scan carry)
        scales = jax.tree.map(lambda v: v.astype(jnp.float32), scales)
        arrays = None  # host-resident; chunks normalized after transfer
    elif compact:
        from fdtd2d.models import datagen as _dg

        if ckpt_scales is not None:
            scales = ckpt_scales
        else:
            # all statistics from the masks' structure — never decode the
            # full f32 channels on host. Chunked two-pass-free moments in
            # f64 (single host core; a full-size f64 temp would be ~27 GB).
            frac_hi = float(np.mean(raw["eps_mask"], dtype=np.float64))
            ez = np.asarray(raw["Ez"])
            cn = max(1, ez.shape[0] // 64)
            tot = ez.size
            s1 = s2 = 0.0
            for c0 in range(0, ez.shape[0], cn):
                c = np.asarray(ez[c0:c0 + cn], np.float64)
                s1 += float(np.sum(c))
                s2 += float(np.sum(c * c))
            std = float(np.sqrt(max(s2 / tot - (s1 / tot) ** 2, 0.0)))
            scales = {
                "eps": _dg.EPS_LO + frac_hi * (_dg.EPS_HI - _dg.EPS_LO),
                "mu": _dg.MU_REF,
                "Ez": std + 1e-30,
                "omega": 1e10,
            }
        scales = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), scales)
        lo = float(_dg.EPS_LO / float(scales["eps"]))
        hi = float(_dg.EPS_HI / float(scales["eps"]))
        affine = {"eps": (hi - lo, lo)}   # src decodes to its raw 0/1 values
        const = {"mu": float(_dg.MU_REF / float(scales["mu"]))}
        ez16 = np.empty(raw["Ez"].shape, np.float16)
        inv = np.float32(1.0 / float(scales["Ez"]))
        for c0 in range(0, ez16.shape[0], 4096):
            ez16[c0:c0 + 4096] = np.asarray(raw["Ez"][c0:c0 + 4096]) * inv
        host = {
            "omega": (np.asarray(raw["omega"], np.float32)
                      / np.float32(float(scales["omega"]))),
            "Ez": ez16,
        }
        # v2 encodings: bit-packed eps + parametric source boxes cut the
        # cache from 4 B/px to 2.125 B/px, which holds the full 50k-scene
        # 256² dataset in ~7 GB.
        eps_mask = np.ascontiguousarray(raw["eps_mask"])
        H, W = eps_mask.shape[1:]
        if W % 8 == 0:
            host["eps_bits"] = np.packbits(eps_mask, axis=-1)
        else:
            host["eps"] = eps_mask
        src_mask = np.asarray(raw["src_mask"])
        rows_any = src_mask.any(axis=2)
        cols_any = src_mask.any(axis=1)
        r0 = rows_any.argmax(1)
        r1 = H - 1 - rows_any[:, ::-1].argmax(1)
        c0 = cols_any.argmax(1)
        c1 = W - 1 - cols_any[:, ::-1].argmax(1)
        area = (r1 - r0 + 1).astype(np.int64) * (c1 - c0 + 1)
        boxy = bool(np.all(src_mask.any(axis=(1, 2)) &
                           (area == src_mask.sum(axis=(1, 2),
                                                 dtype=np.int64))))
        if boxy:
            host["src_box"] = np.stack([r0, r1, c0, c1], 1).astype(np.uint16)
        else:
            # a source that is not an axis-aligned box (future datasets):
            # fall back to the full uint8 mask
            host["src"] = np.ascontiguousarray(src_mask)
        cache_bytes = sum(a.nbytes for a in host.values())
        if cache_bytes > 11e9:
            import warnings

            warnings.warn(
                f"compact device cache needs {cache_bytes / 1e9:.1f} GB of "
                "device memory before model/optimizer/activations. "
                "Train on a subset (fewer shards) or use stream_chunk.",
                stacklevel=2)
        arrays = {k: jnp.asarray(v) for k, v in host.items()}
        del ez16, host
    elif device_dtype is not None:
        scales = ckpt_scales or (compute_scales_host(raw)
                                 if isinstance(raw["Ez"], np.ndarray)
                                 else compute_scales(raw))
        scales = jax.tree.map(lambda v: v.astype(jnp.float32), scales)
        arrays = {}
        for k in ("eps", "mu", "src", "omega", "Ez"):
            v = np.asarray(raw[k], np.float32)
            if k in scales:
                v = v / np.float32(scales[k])
            tgt = np.float32 if k in ("Ez", "omega") else np.dtype(device_dtype)
            # cast on the HOST: halves the one-time transfer too
            arrays[k] = jnp.asarray(np.asarray(v, tgt))
            del v
    else:
        scales = ckpt_scales or compute_scales(raw)
        arrays = normalize(raw, scales)

    # physical-unit eval sample: holdout sample 0 when a holdout exists
    # (a field the model never trains on), else dataset sample 0 (the
    # reference's choice)
    eval_sample = None
    if eval_every > 0 and eval_callback is not None:
        src_set = holdout_set if holdout_set is not None else raw
        if "eps_mask" in src_set:
            from fdtd2d.models.datagen import _decode_compact

            src_set = _decode_compact(
                {k: np.asarray(v[:1]) for k, v in src_set.items()})
        eval_sample = {k: np.asarray(src_set[k][0]) for k in
                       ("eps", "mu", "src", "omega", "Ez")}

    losses = []
    for epoch in range(start_epoch, config.num_epochs):
        key, k_perm, k_epoch = jax.random.split(key, 3)
        if stream_chunk:
            perm_np = np.asarray(jax.random.permutation(k_perm, n))
            chunk_losses = []
            for c0 in range(0, n - stream_chunk + 1, stream_chunk):
                idx = perm_np[c0 : c0 + stream_chunk]
                # f32: the UNet/optimizer state is float32; under x64 a
                # float64 host array would promote the batch_stats and break
                # the train_epoch scan carry
                dev = {k: jnp.asarray(np.asarray(v)[idx], jnp.float32)
                       for k, v in raw.items()}
                dev = normalize(dev, scales)
                k_epoch, k_chunk = jax.random.split(k_epoch)
                state, loss = train_epoch(
                    state, schedule, k_chunk, dev, jnp.arange(stream_chunk),
                    batch_size=config.batch_size,
                    snr_gamma=config.snr_weight_gamma,
                    t_gamma=config.timestep_gamma,
                    prediction_type=config.prediction_type,
                    t_sampling=config.t_sampling,
                    weighting=config.loss_weighting,
                    ema_decay=config.ema_decay, augment=config.augment)
                chunk_losses.append(float(loss))
            mean_loss = float(np.mean(chunk_losses))
        else:
            perm = jax.random.permutation(k_perm, n)
            ep_kwargs = dict(batch_size=config.batch_size,
                             snr_gamma=config.snr_weight_gamma,
                             t_gamma=config.timestep_gamma,
                             prediction_type=config.prediction_type,
                             t_sampling=config.t_sampling,
                             weighting=config.loss_weighting,
                             ema_decay=config.ema_decay,
                             augment=config.augment,
                             affine=affine, const=const)
            nb_total = n // config.batch_size
            n_chunks = max(1, -(-nb_total //
                                max(1, config.max_dispatch_steps)))
            if n_chunks == 1:
                state, mean_loss = train_epoch(state, schedule, k_epoch,
                                               arrays, perm, **ep_kwargs)
            else:
                # split the epoch into equal-size dispatch chunks (identical
                # shapes -> one compile; the < n_chunks leftover steps are
                # dropped, different ones each epoch — see
                # TrainConfig.max_dispatch_steps). Fetching each chunk loss
                # keeps every device window short.
                chunk_steps = nb_total // n_chunks
                span = chunk_steps * config.batch_size
                closses = []
                for ci in range(n_chunks):
                    k_epoch, k_chunk = jax.random.split(k_epoch)
                    cperm = perm[ci * span:(ci + 1) * span]
                    state, cl = train_epoch(state, schedule, k_chunk,
                                            arrays, cperm, **ep_kwargs)
                    closses.append(float(cl))
                mean_loss = float(np.mean(closses))
        losses.append(float(mean_loss))
        if callback:
            callback(epoch, losses[-1], state)
        if eval_sample is not None and (epoch + 1) % eval_every == 0:
            key, k_ev = jax.random.split(key)
            pred = inference(
                ema_state(state), schedule, k_ev,
                jnp.asarray(eval_sample["eps"])[None],
                jnp.asarray(eval_sample["mu"])[None],
                jnp.asarray(eval_sample["src"])[None],
                jnp.asarray(eval_sample["omega"]).reshape(1),
                scales=scales, prediction_type=config.prediction_type)
            eval_callback(epoch, np.asarray(pred[0]), eval_sample["Ez"])
        if (holdout_set is not None and eval_every > 0
                and (epoch + 1) % eval_every == 0):
            key, k_h = jax.random.split(key)
            rel = holdout_relative_l2(ema_state(state), schedule, k_h,
                                      holdout_set, scales,
                                      prediction_type=config.prediction_type)
            if holdout_callback is not None:
                holdout_callback(epoch, rel)
            else:
                print(f"epoch {epoch}: holdout rel-L2 "
                      f"mean {rel.mean():.4f} median {np.median(rel):.4f}")
        if config.ckpt_dir and (epoch + 1) % config.ckpt_every == 0:
            save_checkpoint(config.ckpt_dir, state, epoch, scales=scales)
    # always persist the final state (the reference only saved every 10
    # epochs, so short runs produced nothing restorable)
    if config.ckpt_dir and config.num_epochs > start_epoch:
        save_checkpoint(config.ckpt_dir, state, config.num_epochs - 1,
                        scales=scales)
    return state, losses, scales
