"""Diffusion surrogate: datagen, UNet, DDPM schedule and training.

The UNet (``fdtd2d.models.unet``) and the trainer (``fdtd2d.models.train``)
are imported where they are used, so that the solver-only datagen path
imports no model code.
"""

from fdtd2d.models.diffusion import (
    DDPMSchedule,
    cosine_beta_schedule,
    snr_gamma_weight,
    importance_sample_timesteps,
    loss_weight,
    sample,
)

__all__ = [
    "DDPMSchedule",
    "cosine_beta_schedule",
    "snr_gamma_weight",
    "importance_sample_timesteps",
    "loss_weight",
    "sample",
]
