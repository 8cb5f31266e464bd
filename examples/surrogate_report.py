"""Post-training surrogate report: quantitative holdout metrics + panels.

Restores the final checkpoint (weights + normalization scales), runs DDPM
inference over the held-out scenes, and reports:

- per-sample relative L2 (the raw metric; amplitude-dominated — scene field
  norms span orders of magnitude),
- per-sample Pearson correlation between predicted and true fields
  (scale-invariant structure metric),
- best-scalar-fit relative L2: min_a ||a*pred - true|| / ||true||
  (what the prediction explains after amplitude calibration),

writes the best/median/worst predicted-vs-true panels and the training
curves (loss + holdout rel-L2) to assets.

Run: python examples/surrogate_report.py DATA.npz CKPT_DIR EVAL_DIR OUT_DIR \
        [HOLDOUT] [PRED_TYPE]
PRED_TYPE ("epsilon"|"x0"|"regression") must match the recipe the
checkpoint was trained with; "regression" checkpoints skip the chain-only
readouts (one deterministic pass IS the prediction).
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

from fdtd2d.models.diffusion import DDPMSchedule
from fdtd2d.models.train import (TrainConfig, create_state, ema_state,
                                     inference, regress, restore_checkpoint)
from fdtd2d.viz.plots import plot_ref_v_inference, plot_training_curves


def main(data_path, ckpt_dir, eval_dir, out_dir, holdout=64,
         pred_type="epsilon"):
    os.makedirs(out_dir, exist_ok=True)
    from fdtd2d.models.datagen import load_dataset

    raw = load_dataset(data_path)  # plain npz, compact npz, or shard dir
    hold = {k: np.asarray(raw[k][-holdout:]) for k in
            ("eps", "mu", "src", "omega", "Ez")}

    cfg = TrainConfig()
    state = create_state(jax.random.PRNGKey(0), hold["Ez"].shape[1:], cfg)
    state, epoch, scales = restore_checkpoint(ckpt_dir, state)
    if epoch == 0:
        raise SystemExit(f"no checkpoint in {ckpt_dir}")
    # EMA-trained checkpoints read out through the EMA iterate (no-op else)
    state = ema_state(state)
    print(f"restored epoch {epoch - 1}"
          + (" (EMA readout)" if state.ema_params is not None else ""))
    schedule = DDPMSchedule.create(cfg.num_train_timesteps)

    def infer_all(stochastic, steps=50, seed=123):
        preds = []
        key = jax.random.PRNGKey(seed)
        for c0 in range(0, holdout, 8):
            sl = slice(c0, min(c0 + 8, holdout))
            key, k = jax.random.split(key)
            preds.append(np.asarray(inference(
                state, schedule, k,
                jnp.asarray(hold["eps"][sl]), jnp.asarray(hold["mu"][sl]),
                jnp.asarray(hold["src"][sl]),
                jnp.asarray(hold["omega"][sl]).reshape(-1),
                scales=scales, stochastic=stochastic,
                num_inference_steps=steps, prediction_type=pred_type)))
            print(f"inferred {sl.stop}/{holdout} (stochastic={stochastic}, "
                  f"steps={steps})", flush=True)
        return np.concatenate(preds)

    # a regression checkpoint has no chain: one deterministic pass IS the
    # prediction, so every readout below collapses to the same array —
    # compute it once and skip the chain-only sections
    is_reg = pred_type == "regression"
    pred = infer_all(True)
    pred_det = pred if is_reg else infer_all(False)
    true = hold["Ez"]

    pred_reg = None
    if pred_type == "x0":
        # one-call regression readout (train.regress): the network's direct
        # E[x0|scene] at t=T-1, no chain
        chunks = []
        key = jax.random.PRNGKey(7)
        for c0 in range(0, holdout, 8):
            sl = slice(c0, min(c0 + 8, holdout))
            key, k = jax.random.split(key)
            chunks.append(np.asarray(regress(
                state, schedule, k,
                jnp.asarray(hold["eps"][sl]), jnp.asarray(hold["mu"][sl]),
                jnp.asarray(hold["src"][sl]),
                jnp.asarray(hold["omega"][sl]).reshape(-1), scales=scales)))
        pred_reg = np.concatenate(chunks)

    P = pred.reshape(holdout, -1).astype(np.float64)
    T = true.reshape(holdout, -1).astype(np.float64)
    tn = np.linalg.norm(T, axis=1) + 1e-30
    rel = np.linalg.norm(P - T, axis=1) / tn
    # Pearson correlation per sample
    Pc = P - P.mean(axis=1, keepdims=True)
    Tc = T - T.mean(axis=1, keepdims=True)
    corr = (Pc * Tc).sum(1) / (np.linalg.norm(Pc, axis=1)
                               * np.linalg.norm(Tc, axis=1) + 1e-30)
    # best scalar amplitude fit a* = <P,T>/<P,P>
    a = (P * T).sum(1) / ((P * P).sum(1) + 1e-30)
    rel_fit = np.linalg.norm(a[:, None] * P - T, axis=1) / tn

    def stats(v):
        return (f"mean {np.mean(v):.4f} median {np.median(v):.4f} "
                f"best {np.min(v):.4f} worst {np.max(v):.4f}")

    Pd = pred_det.reshape(holdout, -1).astype(np.float64)
    rel_d = np.linalg.norm(Pd - T, axis=1) / tn
    Pdc = Pd - Pd.mean(axis=1, keepdims=True)
    corr_d = (Pdc * Tc).sum(1) / (np.linalg.norm(Pdc, axis=1)
                                  * np.linalg.norm(Tc, axis=1) + 1e-30)
    a_d = (Pd * T).sum(1) / ((Pd * Pd).sum(1) + 1e-30)
    rel_fit_d = np.linalg.norm(a_d[:, None] * Pd - T, axis=1) / tn

    print(f"holdout ({holdout} scenes, epoch {epoch - 1}):")
    print(f"  relative L2        : {stats(rel)}")
    print(f"  best-fit rel L2    : {stats(rel_fit)}")
    print(f"  Pearson corr       : mean {np.mean(corr):.4f} "
          f"median {np.median(corr):.4f} best {np.max(corr):.4f} "
          f"worst {np.min(corr):.4f}")
    print("  deterministic (DDIM-like) chain:")
    print(f"  relative L2        : {stats(rel_d)}")
    print(f"  best-fit rel L2    : {stats(rel_fit_d)}")
    print(f"  Pearson corr       : mean {np.mean(corr_d):.4f} "
          f"median {np.median(corr_d):.4f} best {np.max(corr_d):.4f} "
          f"worst {np.min(corr_d):.4f}")
    extra = {}
    if pred_reg is not None:
        Pr = pred_reg.reshape(holdout, -1).astype(np.float64)
        rel_r = np.linalg.norm(Pr - T, axis=1) / tn
        Prc = Pr - Pr.mean(axis=1, keepdims=True)
        corr_r = (Prc * Tc).sum(1) / (np.linalg.norm(Prc, axis=1)
                                      * np.linalg.norm(Tc, axis=1) + 1e-30)
        a_r = (Pr * T).sum(1) / ((Pr * Pr).sum(1) + 1e-30)
        rel_fit_r = np.linalg.norm(a_r[:, None] * Pr - T, axis=1) / tn
        print("  one-call regression readout (no chain):")
        print(f"  relative L2        : {stats(rel_r)}")
        print(f"  best-fit rel L2    : {stats(rel_fit_r)}")
        print(f"  Pearson corr       : mean {np.mean(corr_r):.4f} "
              f"median {np.median(corr_r):.4f} best {np.max(corr_r):.4f} "
              f"worst {np.min(corr_r):.4f}")
        extra = dict(rel_r=rel_r, rel_fit_r=rel_fit_r, corr_r=corr_r)

    # posterior-mean ensemble: the conditional task is deterministic, so the
    # Bayes-optimal L2 readout is E[x0|scene]; averaging K independent
    # stochastic chains cancels the sampling variance the single-sample
    # readouts carry.
    from fdtd2d.models.train import ensemble_inference

    K = 1 if is_reg else 8
    ens = np.asarray(ensemble_inference(
        state, schedule, jax.random.PRNGKey(1000),
        jnp.asarray(hold["eps"]), jnp.asarray(hold["mu"]),
        jnp.asarray(hold["src"]), jnp.asarray(hold["omega"]).reshape(-1),
        n_members=K, scales=scales, prediction_type=pred_type,
        chunk=8)).reshape(holdout, -1).astype(np.float64)
    a_e = (ens * T).sum(1) / ((ens * ens).sum(1) + 1e-30)
    rel_fit_e = np.linalg.norm(a_e[:, None] * ens - T, axis=1) / tn
    Ec = ens - ens.mean(axis=1, keepdims=True)
    corr_e = (Ec * Tc).sum(1) / (np.linalg.norm(Ec, axis=1)
                                 * np.linalg.norm(Tc, axis=1) + 1e-30)
    print(f"  ensemble mean of {K} stochastic chains:")
    print(f"  best-fit rel L2    : {stats(rel_fit_e)}")
    print(f"  Pearson corr       : mean {np.mean(corr_e):.4f} "
          f"median {np.median(corr_e):.4f} best {np.max(corr_e):.4f} "
          f"worst {np.min(corr_e):.4f}")
    extra.update(rel_fit_e=rel_fit_e, corr_e=corr_e)

    # chain-length sweep (deterministic chain): for conditional regression
    # readouts, short chains often beat the full 50-step schedule — the late
    # (high-noise) steps only inject posterior-sampling variance. (steps=1
    # would evaluate at t=0 on pure noise — out of distribution; the one-call
    # t=T-1 readout is `regress` above.)
    sweep = {}
    for steps in () if is_reg else (2, 5, 10, 25):
        Ps = infer_all(False, steps).reshape(holdout, -1).astype(np.float64)
        a_s = (Ps * T).sum(1) / ((Ps * Ps).sum(1) + 1e-30)
        rf = np.linalg.norm(a_s[:, None] * Ps - T, axis=1) / tn
        Psc = Ps - Ps.mean(axis=1, keepdims=True)
        cs = (Psc * Tc).sum(1) / (np.linalg.norm(Psc, axis=1)
                                  * np.linalg.norm(Tc, axis=1) + 1e-30)
        print(f"  det chain, {steps:2d} steps: best-fit rel L2 "
              f"mean {np.mean(rf):.4f} median {np.median(rf):.4f}; "
              f"corr mean {np.mean(cs):.4f}")
        sweep[f"rel_fit_s{steps}"] = rf
        sweep[f"corr_s{steps}"] = cs

    np.savez(os.path.join(out_dir, "holdout_report.npz"),
             rel=rel, rel_fit=rel_fit, corr=corr, rel_d=rel_d,
             rel_fit_d=rel_fit_d, corr_d=corr_d, **extra, **sweep)

    # panels from the best readout (lowest mean amplitude-calibrated rel-L2)
    cands = {"det-chain-50": (pred_det, rel_fit_d),
             "ensemble-8": (ens.reshape(true.shape), rel_fit_e)}
    if pred_reg is not None:
        cands["regression"] = (pred_reg, rel_fit_r)
    best_name = min(cands, key=lambda k: np.mean(cands[k][1]))
    panel_pred, panel_rel = cands[best_name]
    order = np.argsort(panel_rel)
    for tag, idx in (("best", order[0]), ("median", order[holdout // 2]),
                     ("worst", order[-1])):
        plot_ref_v_inference(true[idx], panel_pred[idx],
                             os.path.join(out_dir, f"holdout_{tag}.png"))
    print(f"wrote holdout_[best|median|worst].png to {out_dir} "
          f"(readout: {best_name})")

    # training curves from the CLI logs
    csv = os.path.join(eval_dir, "holdout_metrics.csv")
    ep, mean_rel = [], []
    if os.path.exists(csv):
        by_ep = {}
        for line in open(csv):
            f = line.strip().split(",")
            by_ep[int(f[0])] = float(f[1])
        ep = sorted(by_ep)
        mean_rel = [by_ep[e] for e in ep]
    losses = []
    runs_dir = os.path.dirname(eval_dir)
    suffix = ""
    for tag in ("_shape", "_x0"):
        if eval_dir.rstrip("/").endswith(tag):
            suffix = tag
    log = os.path.join(runs_dir, f"train100{suffix}.log")
    log = log if os.path.exists(log) else ""
    if log:
        import re

        # key by epoch number (last occurrence wins): resumed runs re-log
        # the epochs between the restored checkpoint and the interruption
        by_epoch = {}
        for line in open(log):
            m = re.match(r"epoch (\d+): loss ([0-9.eE+-]+)$", line.strip())
            if m:
                by_epoch[int(m.group(1))] = float(m.group(2))
        losses = [by_epoch[e] for e in sorted(by_epoch)]
    if losses:
        plot_training_curves(losses, ep or None, mean_rel or None,
                             os.path.join(out_dir, "training_curves.png"))
        print(f"wrote training_curves.png ({len(losses)} epochs)")


if __name__ == "__main__":
    from fdtd2d.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    a = sys.argv[1:]
    main(a[0] if a else "runs/data10k.npz",
         a[1] if len(a) > 1 else "runs/ckpt10k",
         a[2] if len(a) > 2 else "runs/eval10k",
         a[3] if len(a) > 3 else "assets/surrogate",
         int(a[4]) if len(a) > 4 else 64,
         a[5] if len(a) > 5 else "epsilon")
