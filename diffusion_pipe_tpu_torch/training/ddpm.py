"""DDPM scheduler math for eps / v-prediction training (the SDXL family).

Counterpart of diffusion_pipe_tpu/training/ddpm.py: the scaled-linear beta
schedule in float64, the zero-terminal-SNR rescale, diffusers'
DDPMScheduler add_noise and get_velocity, the SNR table, integer timestep
sampling from an explicit torch.Generator, and the min-SNR-gamma /
debiased-estimation per-example loss weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def scaled_linear_betas(beta_start=0.00085, beta_end=0.012, n=1000) -> np.ndarray:
    """SD / SDXL 'scaled_linear' beta schedule, float64."""
    return np.linspace(beta_start**0.5, beta_end**0.5, n, dtype=np.float64) ** 2


def enforce_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the last timestep has zero SNR (arXiv:2305.08891)."""
    alphas_bar = np.cumprod(1.0 - betas)
    abs_sqrt = np.sqrt(alphas_bar)
    abs_sqrt_0, abs_sqrt_t = abs_sqrt[0], abs_sqrt[-1]
    abs_sqrt = (abs_sqrt - abs_sqrt_t) * abs_sqrt_0 / (abs_sqrt_0 - abs_sqrt_t)
    alphas_bar = abs_sqrt**2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    alphas_cumprod: Tuple[float, ...]
    num_train_timesteps: int = 1000

    @staticmethod
    def sdxl(v_pred: bool = False, zero_terminal_snr: bool = False,
             num_train_timesteps: int = 1000) -> "DDPMSchedule":
        betas = scaled_linear_betas(n=num_train_timesteps)
        if zero_terminal_snr:
            betas = enforce_zero_terminal_snr(betas)
        ac = np.cumprod(1.0 - betas)
        return DDPMSchedule(tuple(float(x) for x in ac), num_train_timesteps)

    def table(self, device=None) -> torch.Tensor:
        """alphas_cumprod [T] f32 on `device`."""
        return torch.tensor(self.alphas_cumprod, dtype=torch.float32, device=device)

    def _coefs(self, latents, timesteps):
        ac = self.table(latents.device)[timesteps.long()]
        shape = (-1,) + (1,) * (latents.dim() - 1)
        return torch.sqrt(ac).reshape(shape), torch.sqrt(1.0 - ac).reshape(shape)

    def add_noise(self, latents, noise, timesteps):
        """diffusers DDPMScheduler.add_noise: sqrt(ab) x0 + sqrt(1 - ab) eps."""
        a, o = self._coefs(latents, timesteps)
        return a * latents + o * noise

    def get_velocity(self, latents, noise, timesteps):
        """v = sqrt(ab) eps - sqrt(1 - ab) x0 (diffusers get_velocity)."""
        a, o = self._coefs(latents, timesteps)
        return a * noise - o * latents

    def snr(self, timesteps):
        ac = self.table(timesteps.device)[timesteps.long()]
        return ac / (1.0 - ac)

    def sample_timesteps(self, batch_size: int, generator: Optional[torch.Generator] = None,
                         quantile: Optional[float] = None, device=None) -> torch.Tensor:
        """[batch_size] int32: uniform over [0, T) from `generator`, or the
        fixed int(quantile * T) when a quantile is given (eval)."""
        if quantile is not None:
            return torch.full((batch_size,), int(quantile * self.num_train_timesteps),
                              dtype=torch.int32, device=device)
        return torch.randint(0, self.num_train_timesteps, (batch_size,), generator=generator,
                             dtype=torch.int32, device=device)


def snr_loss_weight(schedule: DDPMSchedule, timesteps, min_snr_gamma=None,
                    debiased_estimation=False, v_prediction=False) -> torch.Tensor:
    """[B] f32 per-example weight: min-SNR-gamma (min(snr, gamma) / snr, or
    / (snr + 1) for v) times debiased estimation (1 / sqrt(snr), or
    1 / (snr + 1) for v, with snr clipped at 1000); ones when neither is
    configured."""
    snr = schedule.snr(timesteps)
    w = torch.ones_like(snr)
    if min_snr_gamma is not None:
        clipped = torch.clamp(snr, max=float(min_snr_gamma))
        w = w * (clipped / (snr + 1.0) if v_prediction else clipped / torch.clamp(snr, min=1e-8))
    if debiased_estimation:
        snr_t = torch.clamp(snr, max=1000.0)
        w = w * (1.0 / (snr_t + 1.0) if v_prediction
                 else 1.0 / torch.sqrt(torch.clamp(snr_t, min=1e-8)))
    return w
