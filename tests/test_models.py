"""Diffusion surrogate: UNet, schedule, datagen, training, checkpointing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fdtd2d.models.unet import UNet2D, sinusoidal_embedding
from fdtd2d.models.diffusion import (
    DDPMSchedule, cosine_beta_schedule, snr_gamma_weight,
    importance_sample_timesteps,
)
from fdtd2d.models.datagen import (
    random_permittivity, random_source, generate_batch, default_preconditioner,
)
from fdtd2d.models.train import (
    TrainConfig, create_state, train_step, inference,
    save_checkpoint, restore_checkpoint,
)

KEY = jax.random.PRNGKey(0)


def test_cosine_schedule_matches_diffusers_formula():
    """Transcription oracle of diffusers' squaredcos_cap_v2 betas."""
    T = 1000

    def alpha_bar(u):
        return np.cos((u + 0.008) / 1.008 * np.pi / 2) ** 2

    want = np.array([min(1 - alpha_bar((i + 1) / T) / alpha_bar(i / T), 0.999)
                     for i in range(T)])
    got = np.asarray(cosine_beta_schedule(T))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_schedule_add_noise_and_snr_weight():
    s = DDPMSchedule.create(1000)
    x0 = jnp.ones((2, 8, 8))
    noise = jnp.zeros((2, 8, 8))
    t = jnp.asarray([0, 999])
    noisy = s.add_noise(x0, noise, t)
    # early timestep nearly clean, late timestep nearly destroyed
    assert float(noisy[0].mean()) > 0.99
    assert float(noisy[1].mean()) < 0.1
    w = snr_gamma_weight(s, t)
    assert float(w[0]) > 0.99 and float(w[1]) < 1e-4


def test_importance_sampling_prefers_high_snr():
    s = DDPMSchedule.create(1000)
    t = importance_sample_timesteps(s, KEY, 4096, gamma=1.3)
    assert float(jnp.mean(t)) < 500  # skewed toward low t (high SNR)
    assert int(jnp.min(t)) >= 0 and int(jnp.max(t)) < 1000


def test_unet_forward_shapes_and_grads():
    model = UNet2D(channels=(8, 16, 32), bottleneck=64, time_embed_dim=64)
    B, H, W = 2, 32, 32
    f = jnp.ones((B, H, W))
    variables = model.init(KEY, f, f, f, f, jnp.zeros((B,), jnp.int32),
                           jnp.ones((B,)), train=False)
    out = model.apply(variables, f, f, f, f, jnp.zeros((B,), jnp.int32),
                      jnp.ones((B,)), train=False)
    assert out.shape == (B, H, W)
    emb = sinusoidal_embedding(jnp.asarray([3.0]), 64)
    assert emb.shape == (1, 64)


def test_datagen_statistics():
    eps, mu = random_permittivity(KEY, (64, 64))
    vals = np.unique(np.asarray(eps))
    assert len(vals) == 2  # binary field
    frac = float(jnp.mean(eps == vals.max()))
    assert 0.05 < frac < 0.95

    srcs = jax.vmap(lambda k: random_source(k, (64, 64)))(jax.random.split(KEY, 32))
    counts = np.asarray(jnp.sum(srcs, axis=(1, 2)))
    assert counts.min() >= 1  # every sample has a source
    assert (counts > 1).any() and (counts == 1).any()  # lines and points


def test_generate_batch_solves():
    shape = (48, 48)
    M = default_preconditioner(shape, pml_thickness=8)
    out = generate_batch(KEY, batch=4, shape=shape, pml_thickness=8,
                         maxiter=300, M=M)
    assert out["Ez"].shape == (4, 48, 48)
    assert np.all(np.isfinite(np.asarray(out["Ez"])))
    # direct (block-Thomas) labels: TRUE f64 residuals at the c64 floor —
    # the round-2 Krylov path left ~90% of reference-parameter samples
    # above 1e-4
    assert float(jnp.max(out["residuals"])) < 1e-5, (
        f"datagen solves unconverged: {np.asarray(out['residuals'])}")
    assert np.all(np.asarray(out["omega"]) >= 18e9)
    assert np.all(np.asarray(out["omega"]) <= 30e9)


def test_generate_dataset_host_accumulation():
    """to_host=True accumulates numpy batches (datasets past HBM feed the
    streaming train path without ever living on device)."""
    from fdtd2d.models.datagen import generate_dataset

    shape = (48, 48)
    M = default_preconditioner(shape, pml_thickness=8)
    data = generate_dataset(KEY, 6, shape, batch=4, pml_thickness=8,
                            maxiter=100, M=M, to_host=True)
    assert isinstance(data["Ez"], np.ndarray)
    assert data["Ez"].shape == (6, 48, 48)
    assert np.all(np.isfinite(data["Ez"]))


def test_dataset_compact_roundtrip(tmp_path):
    """Compact (mask-encoded) npz storage is LOSSLESS for datagen output:
    eps is binary, src is a 0/1 mask, mu is constant (datagen.py docstring;
    reference python-src/diffusion_training.py:54-146 draws only
    eps/src/omega)."""
    from fdtd2d.models.datagen import (generate_dataset, load_dataset,
                                           save_dataset)

    shape = (48, 48)
    M = default_preconditioner(shape, pml_thickness=8)
    data = generate_dataset(KEY, 4, shape, batch=4, pml_thickness=8,
                            maxiter=100, M=M, to_host=True)
    p = str(tmp_path / "compact.npz")
    save_dataset(p, data, compact=True)
    back = load_dataset(p)
    for k in ("eps", "mu", "src", "omega", "Ez", "residuals"):
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(data[k]), err_msg=k)
    # the compact file is materially smaller than the plain one
    import os

    p2 = str(tmp_path / "plain.npz")
    save_dataset(p2, data, compact=False)
    assert os.path.getsize(p) < 0.6 * os.path.getsize(p2)


def test_dataset_shards_resume(tmp_path):
    """Sharded datagen skips existing shards (resumable) and load_dataset
    concatenates a shard directory into the standard key set."""
    from fdtd2d.models.datagen import (generate_dataset_shards,
                                           load_dataset)

    d = str(tmp_path / "shards")
    kw = dict(shard_size=4, batch=4, pml_thickness=8, maxiter=100)
    n1 = generate_dataset_shards(KEY, 10, (48, 48), d, **kw)
    assert n1 == 3  # 4 + 4 + 2
    n2 = generate_dataset_shards(KEY, 10, (48, 48), d, **kw)
    assert n2 == 0  # all shards exist -> nothing regenerated
    data = load_dataset(d)
    assert data["Ez"].shape == (10, 48, 48)
    assert data["eps"].shape == (10, 48, 48)
    assert np.all(np.isfinite(data["Ez"]))
    # shard RNG is fold_in(key, i): shard 1's first sample differs from
    # shard 0's first sample
    assert not np.array_equal(data["Ez"][0], data["Ez"][4])


@pytest.mark.slow
def test_train_streaming_chunks():
    """stream_chunk path: host data, chunked transfer, same API surface."""
    from fdtd2d.models.train import TrainConfig, train

    data = {k: np.asarray(v) for k, v in _tiny_data(n=12).items()}
    cfg = TrainConfig(batch_size=2, num_epochs=2)
    evals = []
    state, losses, scales = train(
        jax.random.PRNGKey(0), data, cfg, stream_chunk=4,
        eval_every=2, eval_callback=lambda e, p, t: evals.append((e, p.shape)),
        state=create_state(jax.random.PRNGKey(2), (32, 32), cfg,
                           model=_tiny_model()))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert evals and evals[0][1] == (32, 32)


def _tiny_data(n=8, hw=32):
    k = jax.random.PRNGKey(1)
    return {
        "eps": jax.random.uniform(k, (n, hw, hw)),
        "mu": jnp.ones((n, hw, hw)),
        "src": jnp.zeros((n, hw, hw)).at[:, hw // 2, hw // 2].set(1.0),
        "omega": jnp.linspace(0.5, 1.5, n),
        "Ez": jax.random.normal(k, (n, hw, hw)),
    }


def _tiny_model():
    return UNet2D(channels=(4, 8, 16), bottleneck=32, time_embed_dim=32)


def test_train_step_and_inference():
    data = _tiny_data()
    cfg = TrainConfig(batch_size=4)
    state = create_state(KEY, (32, 32), cfg, model=_tiny_model())
    schedule = DDPMSchedule.create(1000)
    batch = {k: v[:4] for k, v in data.items()}
    losses = []
    for i in range(3):
        state, loss = train_step(state, schedule, jax.random.PRNGKey(i), batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses))

    out = inference(state, schedule, KEY, *[batch[k] for k in ("eps", "mu", "src")],
                    batch["omega"], num_inference_steps=5)
    assert out.shape == (4, 32, 32)
    assert np.all(np.isfinite(np.asarray(out)))


@pytest.mark.slow
def test_train_step_bfloat16_mixed_precision():
    """compute_dtype='bfloat16' runs the conv/dense math in bf16 while
    master params, the optimizer state, and the loss stay float32, and the
    output is close to the float32 model with identical params (standard
    mixed precision on the bf16 tensor cores)."""
    data = _tiny_data()
    cfg = TrainConfig(batch_size=4, compute_dtype="bfloat16")
    model = UNet2D(channels=(4, 8, 16), bottleneck=32, time_embed_dim=32,
                   dtype=jnp.bfloat16)
    state = create_state(KEY, (32, 32), cfg, model=model)
    # master params and opt state are float32 regardless of compute dtype
    assert all(p.dtype == jnp.float32 for p in jax.tree.leaves(state.params))
    assert all(x.dtype != jnp.bfloat16 for x in jax.tree.leaves(state.opt_state)
               if hasattr(x, "dtype"))

    batch = {k: v[:4] for k, v in data.items()}
    schedule = DDPMSchedule.create(1000)
    for i in range(2):
        state, loss = train_step(state, schedule, jax.random.PRNGKey(i), batch)
        assert loss.dtype == jnp.float32 and np.isfinite(float(loss))

    # bf16 forward tracks the f32 forward with the SAME params to bf16
    # roundoff (~1e-2 relative on O(1) activations)
    f32 = UNet2D(channels=(4, 8, 16), bottleneck=32, time_embed_dim=32)
    args = (batch["eps"], batch["mu"], batch["src"], batch["Ez"],
            jnp.zeros((4,)), batch["omega"])
    vars_ = {"params": state.params, "batch_stats": state.batch_stats}
    y_bf = model.apply(vars_, *args, train=False)
    y_f32 = f32.apply(vars_, *args, train=False)
    assert y_bf.dtype == jnp.float32         # head + output stay f32
    denom = float(jnp.max(jnp.abs(y_f32))) + 1e-30
    assert float(jnp.max(jnp.abs(y_bf - y_f32))) / denom < 5e-2


def test_checkpoint_roundtrip(tmp_path):
    cfg = TrainConfig(batch_size=4, ckpt_dir=str(tmp_path))
    state = create_state(KEY, (32, 32), cfg, model=_tiny_model())
    schedule = DDPMSchedule.create(100)
    batch = {k: v[:4] for k, v in _tiny_data().items()}
    state, _ = train_step(state, schedule, KEY, batch)
    scales = {"eps": jnp.asarray(2.0), "mu": jnp.asarray(3.0),
              "Ez": jnp.asarray(0.5), "omega": jnp.asarray(1e10)}
    save_checkpoint(str(tmp_path), state, epoch=3, scales=scales)

    fresh = create_state(jax.random.PRNGKey(9), (32, 32), cfg, model=_tiny_model())
    restored, next_epoch, restored_scales = restore_checkpoint(str(tmp_path), fresh)
    assert next_epoch == 4
    assert restored_scales is not None
    for k, v in scales.items():
        assert float(restored_scales[k]) == float(v), k
    a = jax.tree.leaves(state.params)
    b = jax.tree.leaves(restored.params)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert int(restored.step) == int(state.step)


def test_train_holdout_metric(tmp_path):
    """holdout: last-N samples withheld; rel-L2 computed per eval epoch;
    panel uses the holdout sample (the quantitative
    surrogate metric)."""
    from fdtd2d.models.train import TrainConfig, train

    n, H = 12, 16
    rng = np.random.default_rng(0)
    data = {
        "eps": jnp.asarray(rng.random((n, H, H)), jnp.float32),
        "mu": jnp.ones((n, H, H), jnp.float32),
        "src": jnp.zeros((n, H, H), jnp.float32),
        "omega": jnp.full((n,), 2.4e10, jnp.float32),
        "Ez": jnp.asarray(rng.standard_normal((n, H, H)), jnp.float32),
    }
    cfg = TrainConfig(batch_size=4, num_epochs=2, num_train_timesteps=20)
    seen = []
    panels = []
    _, losses, _ = train(
        jax.random.PRNGKey(0), data, cfg, eval_every=1,
        eval_callback=lambda e, p, t: panels.append((e, p.shape, t.shape)),
        holdout=4, holdout_callback=lambda e, rel: seen.append((e, rel)))
    assert len(losses) == 2
    assert [e for e, _ in seen] == [0, 1]
    for _, rel in seen:
        assert rel.shape == (4,)
        assert np.all(np.isfinite(rel)) and np.all(rel > 0)
    assert panels and panels[0][1] == (H, H)


def test_train_device_cache_f16():
    """device_dtype=float16 compact cache: inputs stored f16 on device,
    training still converges finitely and matches the f32 path's API."""
    from fdtd2d.models.train import TrainConfig, train

    data = {k: np.asarray(v) for k, v in _tiny_data(n=8).items()}
    cfg = TrainConfig(batch_size=4, num_epochs=2)
    state, losses, scales = train(
        jax.random.PRNGKey(0), data, cfg, device_dtype=jnp.float16,
        state=create_state(jax.random.PRNGKey(2), (32, 32), cfg,
                           model=_tiny_model()))
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_device_cache_compact(tmp_path):
    """device_dtype="compact": uint8 masks + f16 labels on device, mu never
    stored; the affine/const decode in train_epoch reproduces the normalized
    channels (exactly for the binary eps/src, to f16 rounding for Ez);
    holdout metric and eval panel run on decoded physical-unit samples."""
    from fdtd2d.models import datagen as dg
    from fdtd2d.models.train import TrainConfig, train

    n, H = 12, 32
    rng = np.random.default_rng(0)
    mask = rng.random((n, H, H)) > 0.5
    data = {
        "eps": np.where(mask, np.float32(dg.EPS_HI), np.float32(dg.EPS_LO)),
        "mu": np.full((n, H, H), dg.MU_REF, np.float32),
        "src": np.zeros((n, H, H), np.float32),
        "omega": np.full((n,), 2.4e10, np.float32),
        "Ez": rng.standard_normal((n, H, H)).astype(np.float32),
    }
    data["src"][:, H // 2, H // 2] = 1.0
    p = str(tmp_path / "c.npz")
    dg.save_dataset(p, data, compact=True)
    raw = dg.load_dataset(p, decode=False)
    assert raw["eps_mask"].dtype == np.uint8 and "compact_version" not in raw

    cfg = TrainConfig(batch_size=4, num_epochs=2, num_train_timesteps=20)
    seen, panels = [], []
    state, losses, scales = train(
        jax.random.PRNGKey(0), raw, cfg, device_dtype="compact",
        holdout=4, eval_every=1,
        eval_callback=lambda e, pr, t: panels.append((pr.shape, t.shape)),
        holdout_callback=lambda e, rel: seen.append(rel),
        state=create_state(jax.random.PRNGKey(2), (H, H), cfg,
                           model=_tiny_model()))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert seen and all(r.shape == (4,) and np.all(np.isfinite(r))
                        for r in seen)
    assert panels and panels[0] == ((H, H), (H, H))
    # scales come from the masks' structure and must equal the decoded
    # training split's statistics
    tr = slice(None, -4)
    assert np.isclose(float(scales["eps"]), np.mean(data["eps"][tr]),
                      rtol=1e-5)
    assert np.isclose(float(scales["Ez"]),
                      np.std(np.asarray(data["Ez"][tr], np.float64)),
                      rtol=1e-4)
    assert float(scales["mu"]) == np.float32(dg.MU_REF)

    # guardrails: decoded data and stream_chunk are both rejected
    with pytest.raises(ValueError, match="decode=False"):
        train(jax.random.PRNGKey(0), data, cfg, device_dtype="compact")
    with pytest.raises(ValueError, match="alternatives"):
        train(jax.random.PRNGKey(0), raw, cfg, device_dtype="compact",
              stream_chunk=4)


def test_loss_weight_modes():
    """loss_weight: reference parity for snr_gamma/epsilon; min-SNR and
    uniform cover all timesteps (the property the reference recipe lacks —
    its effective gradient mass at t>500 is ~1e-5, which is why a model
    trained with it cannot generate from a full chain)."""
    from fdtd2d.models.diffusion import loss_weight

    s = DDPMSchedule.create(1000)
    t = jnp.asarray([5, 500, 900])
    np.testing.assert_allclose(
        np.asarray(loss_weight(s, t, "snr_gamma", "epsilon")),
        np.asarray(snr_gamma_weight(s, t)), rtol=1e-6)
    w_min = np.asarray(loss_weight(s, t, "min_snr", "epsilon", gamma=5.0))
    snr = np.asarray(s.alphas_cumprod[t] / (1 - s.alphas_cumprod[t]))
    np.testing.assert_allclose(w_min, np.minimum(snr, 5.0) / snr, rtol=1e-5)
    assert w_min[2] == 1.0  # high-noise steps get full weight
    w_u = np.asarray(loss_weight(s, t, "uniform", "x0"))
    np.testing.assert_allclose(w_u, 1.0)
    # x0-mode min-SNR is the epsilon-mode weight times SNR
    w_min_x0 = np.asarray(loss_weight(s, t, "min_snr", "x0", gamma=5.0))
    np.testing.assert_allclose(w_min_x0, np.minimum(snr, 5.0), rtol=1e-5)
    with pytest.raises(ValueError):
        loss_weight(s, t, "nope", "x0")


def test_train_step_x0_uniform_recipe():
    """The generating recipe (x0 prediction, uniform t, uniform weight):
    finite decreasing-ish loss and inference consumes the x0 output."""
    data = _tiny_data()
    cfg = TrainConfig(batch_size=4, prediction_type="x0",
                      t_sampling="uniform", loss_weighting="uniform")
    state = create_state(KEY, (32, 32), cfg, model=_tiny_model())
    schedule = DDPMSchedule.create(1000)
    batch = {k: v[:4] for k, v in data.items()}
    losses = []
    for i in range(4):
        state, loss = train_step(state, schedule, jax.random.PRNGKey(i), batch,
                                 prediction_type="x0", t_sampling="uniform",
                                 weighting="uniform")
        losses.append(float(loss))
    assert all(np.isfinite(losses))

    out = inference(state, schedule, KEY,
                    *[batch[k] for k in ("eps", "mu", "src")],
                    batch["omega"], num_inference_steps=5,
                    prediction_type="x0")
    assert out.shape == (4, 32, 32)
    assert np.all(np.isfinite(np.asarray(out)))


def test_train_step_regression_recipe():
    """prediction_type="regression": plain supervised surrogate — loss is
    exactly MSE(pred, Ez) with no noise involvement, training reduces it,
    and inference is one deterministic forward pass (key-independent)."""
    data = _tiny_data()
    cfg = TrainConfig(batch_size=4, prediction_type="regression")
    state = create_state(KEY, (32, 32), cfg, model=_tiny_model())
    schedule = DDPMSchedule.create(1000)
    batch = {k: v[:4] for k, v in data.items()}
    losses = []
    for i in range(12):
        state, loss = train_step(state, schedule, jax.random.PRNGKey(i),
                                 batch, prediction_type="regression")
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], f"regression loss not decreasing: {losses}"

    out1 = inference(state, schedule, jax.random.PRNGKey(0),
                     *[batch[k] for k in ("eps", "mu", "src")],
                     batch["omega"], prediction_type="regression")
    out2 = inference(state, schedule, jax.random.PRNGKey(99),
                     *[batch[k] for k in ("eps", "mu", "src")],
                     batch["omega"], prediction_type="regression")
    assert out1.shape == (4, 32, 32)
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))

    # the regression loss is the plain per-batch MSE of that forward pass
    pred, _ = state.apply_fn(
        {"params": state.params, "batch_stats": state.batch_stats},
        batch["eps"], batch["mu"], batch["src"],
        jnp.zeros_like(batch["Ez"]), jnp.zeros((4,), jnp.int32),
        batch["omega"], train=True, mutable=["batch_stats"])
    want = float(jnp.mean((pred - batch["Ez"]) ** 2))
    state2, loss = train_step(state, schedule, KEY, batch,
                              prediction_type="regression")
    assert abs(float(loss) - want) < 1e-5 * max(1.0, abs(want))


def test_sample_t_start_truncation():
    """t_start truncates the ladder; a perfect x0 oracle then recovers the
    field from any start point (unit-variance marginal at every t)."""
    from fdtd2d.models.diffusion import sample

    schedule = DDPMSchedule.create(1000)
    x_true = jax.random.normal(jax.random.PRNGKey(3), (2, 16, 16))
    x_true = x_true / jnp.std(x_true, axis=(1, 2), keepdims=True)

    def oracle(eps, mu, src, x, t, om):
        return x_true  # perfect x0 predictor

    z = jnp.zeros((2, 16, 16))
    out = sample(schedule, oracle, KEY, z, z, z, jnp.zeros((2,)),
                 num_inference_steps=10, stochastic=False,
                 prediction_type="x0", t_start=400)
    err = float(jnp.linalg.norm(out - x_true) / jnp.linalg.norm(x_true))
    assert err < 0.05, err
    with pytest.raises(ValueError):
        sample(schedule, oracle, KEY, z, z, z, jnp.zeros((2,)),
               num_inference_steps=10, t_start=-1)


def test_regress_readout():
    """regress(): one-call x0 readout — right shape, finite, and honors the
    normalization scales roundtrip."""
    from fdtd2d.models.train import regress

    data = _tiny_data()
    cfg = TrainConfig(batch_size=4)
    state = create_state(KEY, (32, 32), cfg, model=_tiny_model())
    schedule = DDPMSchedule.create(1000)
    batch = {k: v[:4] for k, v in data.items()}
    scales = {"eps": jnp.asarray(2.0), "mu": jnp.asarray(1.0),
              "Ez": jnp.asarray(3.0), "omega": jnp.asarray(1.0)}
    out = regress(state, schedule, KEY,
                  *[batch[k] for k in ("eps", "mu", "src")], batch["omega"],
                  scales=scales)
    assert out.shape == (4, 32, 32)
    assert np.all(np.isfinite(np.asarray(out)))
    out_unscaled = regress(
        state, schedule, KEY,
        batch["eps"] / 2.0, batch["mu"], batch["src"], batch["omega"])
    np.testing.assert_allclose(np.asarray(out), 3.0 * np.asarray(out_unscaled),
                               rtol=1e-5)


def test_ensemble_inference_readout():
    """ensemble_inference(): mean of stochastic chains — right shape,
    finite, equals a single chain at n_members=1, and has LOWER spread than
    single members (variance cancellation)."""
    from fdtd2d.models.train import ensemble_inference, inference

    data = _tiny_data()
    cfg = TrainConfig(batch_size=4)
    state = create_state(KEY, (32, 32), cfg, model=_tiny_model())
    schedule = DDPMSchedule.create(1000)
    batch = {k: v[:4] for k, v in data.items()}
    args = [batch[k] for k in ("eps", "mu", "src")] + [batch["omega"]]

    one = ensemble_inference(state, schedule, KEY, *args, n_members=1,
                             num_inference_steps=5, prediction_type="x0")
    k1 = jax.random.split(KEY)[1]
    direct = inference(state, schedule, k1, *args, num_inference_steps=5,
                       stochastic=True, prediction_type="x0")
    np.testing.assert_allclose(np.asarray(one), np.asarray(direct), rtol=1e-6)

    ens = ensemble_inference(state, schedule, KEY, *args, n_members=6,
                             num_inference_steps=5, prediction_type="x0")
    assert ens.shape == (4, 32, 32)
    assert np.all(np.isfinite(np.asarray(ens)))
    # members scatter around the ensemble mean: the mean's deviation from a
    # fresh member is dominated by that member's own noise, and the ensemble
    # has strictly smaller spread around it than single members do
    k2 = jax.random.PRNGKey(99)
    fresh = inference(state, schedule, k2, *args, num_inference_steps=5,
                      stochastic=True, prediction_type="x0")
    d_ens = float(jnp.linalg.norm(ens - fresh))
    d_one = float(jnp.linalg.norm(one - fresh))
    assert d_ens < d_one, (d_ens, d_one)


def test_ensemble_inference_chunked():
    """chunk > 0 keeps only chunk samples' activations live; the chunked
    readout has the same shape/statistics (finite, comparable scale) as the
    unchunked one (different noise draws, so not bitwise equal)."""
    from fdtd2d.models.train import ensemble_inference

    data = _tiny_data()
    cfg = TrainConfig(batch_size=4)
    state = create_state(KEY, (32, 32), cfg, model=_tiny_model())
    schedule = DDPMSchedule.create(1000)
    batch = {k: v[:4] for k, v in data.items()}
    args = [batch[k] for k in ("eps", "mu", "src")] + [batch["omega"]]

    full = ensemble_inference(state, schedule, KEY, *args, n_members=3,
                              num_inference_steps=5, prediction_type="x0")
    chunked = ensemble_inference(state, schedule, KEY, *args, n_members=3,
                                 num_inference_steps=5,
                                 prediction_type="x0", chunk=2)
    assert chunked.shape == full.shape == (4, 32, 32)
    assert np.all(np.isfinite(np.asarray(chunked)))
    r = float(jnp.linalg.norm(chunked - full) / jnp.linalg.norm(full))
    assert r < 1.0, r


# ---------------------------------------------------------------------------
# D4 augmentation + EMA (the two levers against surrogate run-to-run variance and the unique-scene cap)
# ---------------------------------------------------------------------------


def test_dihedral_matches_numpy_group():
    """dihedral(x, g): g%4 CCW rot90s, g>=4 flips axis -2 first — pinned
    against numpy's rot90/flipud for all 8 group elements."""
    from fdtd2d.models.augment import dihedral

    x = np.arange(30, dtype=np.float32).reshape(5, 6)[:, :5]  # asymmetric
    for g in range(8):
        got = np.asarray(dihedral(jnp.asarray(x), g))
        want = np.rot90(np.flipud(x) if g >= 4 else x, k=g % 4)
        np.testing.assert_array_equal(got, want, err_msg=f"g={g}")
    with pytest.raises(ValueError):
        dihedral(jnp.zeros((4, 6)), 1)  # non-square spatial dims


@pytest.mark.slow
def test_dihedral_physics_equivariance():
    """The discrete Helmholtz solve commutes with D4 on square scenes with
    symmetric PML (models/augment.py docstring): Ez(g.scene) == g.Ez(scene).
    Verified against the exact direct solver — this is the claim that makes
    --augment a physically exact 8x dataset multiplier."""
    from fdtd2d import constants
    from fdtd2d.fdfd.direct import DirectSolver
    from fdtd2d.models.augment import dihedral

    N, dx, omega = 64, 1e-3, 17e9
    eps = np.full((N, N), constants.EPSILON_0)
    eps[10:30, 18:40] *= 2.0
    eps[40:52, 8:20] *= 1.5
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N))
    src[22, 37] = 1.0

    base, trace = DirectSolver(eps, mu, dx, dx, omega,
                               pml_thickness=12).solve(src, refine_target=1e-9)
    # trace[-2] is the f64 iterate's residual; trace[-1] the returned
    # complex64 downcast's own (floored near c64 eps — the honest-residual
    # contract, fdfd/solver.py)
    assert trace[-2] < 1e-8
    base = np.asarray(base)
    for g in (1, 3, 4, 6):
        te = np.asarray(dihedral(jnp.asarray(eps), g))
        tm = np.asarray(dihedral(jnp.asarray(mu), g))
        ts = np.asarray(dihedral(jnp.asarray(src), g))
        got, _ = DirectSolver(te, tm, dx, dx, omega,
                              pml_thickness=12).solve(ts, refine_target=1e-9)
        want = np.asarray(dihedral(jnp.asarray(base), g))
        # both fields are c64 downcasts of ~1e-9-residual solves; a broken
        # equivariance claim would show O(1) mismatch, the c64 floor ~1e-5
        rel = np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want)
        assert rel < 1e-4, f"g={g}: rel error {rel:.2e}"


def test_augment_batch_moves_field_with_scene():
    from fdtd2d.models.augment import augment_batch

    data = _tiny_data(n=16)
    batch = dict(data)
    batch["Ez"] = batch["eps"]  # field == scene: must STAY equal per sample
    out = augment_batch(jax.random.PRNGKey(2), batch)
    np.testing.assert_array_equal(np.asarray(out["Ez"]), np.asarray(out["eps"]))
    assert out["omega"] is batch["omega"]  # non-spatial passthrough
    # with 16 samples, some g != identity with overwhelming probability
    assert not np.array_equal(np.asarray(out["eps"]), np.asarray(batch["eps"]))


def test_ema_one_step_recursion():
    from fdtd2d.models.train import ema_state

    cfg = TrainConfig(batch_size=4, ema_decay=0.5)
    state = create_state(KEY, (32, 32), cfg, model=_tiny_model())
    p0 = jax.tree.map(np.asarray, state.params)
    schedule = DDPMSchedule.create(100)
    batch = {k: v[:4] for k, v in _tiny_data().items()}
    state, _ = train_step(state, schedule, KEY, batch, ema_decay=0.5)
    # warmup-effective decay after the first step (state.step == 1):
    # min(0.5, (1+1)/(10+1)) = 2/11
    eff = 2.0 / 11.0
    want = jax.tree.map(lambda a, b: eff * a + (1.0 - eff) * np.asarray(b),
                        p0, state.params)
    for w, e in zip(jax.tree.leaves(want), jax.tree.leaves(state.ema_params)):
        np.testing.assert_allclose(np.asarray(e), w, rtol=1e-6)
    # readout state swaps params for the EMA; training state is untouched
    assert ema_state(state).params is state.ema_params
    # ema_decay=0 runs keep no EMA tree at all
    s0 = create_state(KEY, (32, 32), TrainConfig(batch_size=4),
                      model=_tiny_model())
    assert s0.ema_params is None and ema_state(s0) is s0


def test_train_augment_ema_e2e():
    from fdtd2d.models.train import train

    data = {k: jnp.asarray(v) for k, v in _tiny_data(n=8).items()}
    cfg = TrainConfig(batch_size=4, num_epochs=2, ema_decay=0.9, augment=True)
    state, losses, scales = train(KEY, data, cfg)
    assert np.all(np.isfinite(losses))
    assert state.ema_params is not None
    # EMA must differ from the raw params after optimizer steps
    diffs = [float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
             for a, b in zip(jax.tree.leaves(state.ema_params),
                             jax.tree.leaves(state.params))]
    assert max(diffs) > 0


@pytest.mark.slow
def test_checkpoint_roundtrip_ema(tmp_path):
    cfg = TrainConfig(batch_size=4, ema_decay=0.9)
    state = create_state(KEY, (32, 32), cfg, model=_tiny_model())
    schedule = DDPMSchedule.create(100)
    batch = {k: v[:4] for k, v in _tiny_data().items()}
    state, _ = train_step(state, schedule, KEY, batch, ema_decay=0.9)
    scales = {"eps": jnp.asarray(2.0), "mu": jnp.asarray(3.0),
              "Ez": jnp.asarray(0.5), "omega": jnp.asarray(1e10)}
    save_checkpoint(str(tmp_path), state, epoch=0, scales=scales)

    # EMA-enabled restore round-trips the EMA tree exactly
    fresh = create_state(jax.random.PRNGKey(9), (32, 32), cfg,
                         model=_tiny_model())
    restored, _, _ = restore_checkpoint(str(tmp_path), fresh)
    for a, b in zip(jax.tree.leaves(state.ema_params),
                    jax.tree.leaves(restored.ema_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # an EMA-unaware caller (the `fdtd2d infer` path, default config) must
    # still pick up the stored EMA instead of structure-mismatching
    fresh0 = create_state(jax.random.PRNGKey(9), (32, 32),
                          TrainConfig(batch_size=4), model=_tiny_model())
    restored0, _, _ = restore_checkpoint(str(tmp_path), fresh0)
    assert restored0.ema_params is not None
    for a, b in zip(jax.tree.leaves(state.ema_params),
                    jax.tree.leaves(restored0.ema_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # pre-EMA checkpoint into an EMA-enabled state: warn + re-seed from params
    state_plain = create_state(KEY, (32, 32), TrainConfig(batch_size=4),
                               model=_tiny_model())
    save_checkpoint(str(tmp_path / "plain"), state_plain, epoch=0,
                    scales=scales)
    with pytest.warns(UserWarning, match="no EMA params"):
        restored2, _, _ = restore_checkpoint(str(tmp_path / "plain"), fresh)
    for a, b in zip(jax.tree.leaves(restored2.params),
                    jax.tree.leaves(restored2.ema_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_resume_without_ema_decay_drops_stale_ema(tmp_path):
    """Resuming TRAINING with ema_decay=0 from an EMA checkpoint must not
    leave the stale old-run EMA attached: train_step would never update it,
    yet all readouts go through ema_state(state) (advisor r3, medium)."""
    from fdtd2d.models.train import train

    cfg_ema = TrainConfig(batch_size=4, num_epochs=1, ema_decay=0.9,
                          ckpt_dir=str(tmp_path))
    data = {k: jnp.asarray(v) for k, v in _tiny_data(n=8).items()}
    # train() builds its own UNet2D at the data shape; 32x32 is fine
    state, _, _ = train(KEY, data, cfg_ema)
    assert state.ema_params is not None

    cfg_plain = TrainConfig(batch_size=4, num_epochs=2, ema_decay=0.0,
                            ckpt_dir=str(tmp_path))
    with pytest.warns(UserWarning, match="discarding the stored EMA"):
        state2, _, _ = train(KEY, data, cfg_plain)
    assert state2.ema_params is None


def test_compact_v2_decode_parity():
    """The v2 compact cache entries (bit-packed ``eps_bits``, parametric
    ``src_box``) must decode to EXACTLY the batches the v1 uint8 masks
    produce: identical loss for the same key, with and without augment."""
    from fdtd2d.models.train import (TrainConfig, create_state,
                                         train_epoch)
    from fdtd2d.models.diffusion import DDPMSchedule

    n, H = 8, 32
    rng = np.random.default_rng(3)
    eps_mask = (rng.random((n, H, H)) > 0.5).astype(np.uint8)
    src_mask = np.zeros((n, H, H), np.uint8)
    box = np.zeros((n, 4), np.uint16)
    for i in range(n):
        r = rng.integers(4, H - 8)
        c = rng.integers(4, H - 8)
        if i % 2:  # horizontal 5-px line
            src_mask[i, r, c:c + 5] = 1
            box[i] = (r, r, c, c + 4)
        else:      # point
            src_mask[i, r, c] = 1
            box[i] = (r, r, c, c)
    ez16 = rng.standard_normal((n, H, H)).astype(np.float16)
    omega = np.full((n,), 1.2, np.float32)

    v1 = {"eps": jnp.asarray(eps_mask), "src": jnp.asarray(src_mask),
          "omega": jnp.asarray(omega), "Ez": jnp.asarray(ez16)}
    v2 = {"eps_bits": jnp.asarray(np.packbits(eps_mask, axis=-1)),
          "src_box": jnp.asarray(box),
          "omega": jnp.asarray(omega), "Ez": jnp.asarray(ez16)}

    cfg = TrainConfig(batch_size=4, num_train_timesteps=20)
    schedule = DDPMSchedule.create(cfg.num_train_timesteps)
    affine = {"eps": (2.0, 1.0)}
    const = {"mu": 1.0}
    perm = jnp.arange(n)
    for augment in (False, True):
        losses = []
        for data in (v1, v2):
            state = create_state(jax.random.PRNGKey(2), (H, H), cfg,
                                 model=_tiny_model())
            _, loss = train_epoch(state, schedule, jax.random.PRNGKey(5),
                                  data, perm, batch_size=4,
                                  prediction_type="x0",
                                  t_sampling="uniform", weighting="uniform",
                                  augment=augment,
                                  affine=affine, const=const)
            losses.append(float(loss))
        assert losses[0] == losses[1], (augment, losses)


def test_compact_v2_nonboxy_fallback(tmp_path):
    """A source mask that is NOT an axis-aligned box (diagonal) must fall
    back to the full uint8 mask path and still train."""
    from fdtd2d.models import datagen as dg
    from fdtd2d.models.train import TrainConfig, create_state, train

    n, H = 8, 32
    rng = np.random.default_rng(4)
    mask = rng.random((n, H, H)) > 0.5
    data = {
        "eps": np.where(mask, np.float32(dg.EPS_HI), np.float32(dg.EPS_LO)),
        "mu": np.full((n, H, H), dg.MU_REF, np.float32),
        "src": np.zeros((n, H, H), np.float32),
        "omega": np.full((n,), 2.4e10, np.float32),
        "Ez": rng.standard_normal((n, H, H)).astype(np.float32),
    }
    for i in range(n):  # diagonal source: bounding-box area != pixel count
        data["src"][i, 10 + np.arange(4), 10 + np.arange(4)] = 1.0
    p = str(tmp_path / "diag.npz")
    dg.save_dataset(p, data, compact=True)
    raw = dg.load_dataset(p, decode=False)
    cfg = TrainConfig(batch_size=4, num_epochs=1, num_train_timesteps=20)
    state, losses, _ = train(
        jax.random.PRNGKey(0), raw, cfg, device_dtype="compact",
        state=create_state(jax.random.PRNGKey(2), (H, H), cfg,
                           model=_tiny_model()))
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_epoch_dispatch_chunking():
    """max_dispatch_steps splits an epoch into equal-size dispatch chunks
    (the long-dispatch guard); loss stays finite and the
    state advances identically in shape to the single-dispatch path."""
    from fdtd2d.models.train import TrainConfig, train

    data = {k: np.asarray(v) for k, v in _tiny_data(n=16).items()}
    cfg = TrainConfig(batch_size=4, num_epochs=2, num_train_timesteps=20,
                      max_dispatch_steps=2)  # nb_total=4 -> 2 chunks of 2
    state, losses, _ = train(
        jax.random.PRNGKey(0), data, cfg,
        state=create_state(jax.random.PRNGKey(2), (32, 32), cfg,
                           model=_tiny_model()))
    assert len(losses) == 2 and all(np.isfinite(losses))
