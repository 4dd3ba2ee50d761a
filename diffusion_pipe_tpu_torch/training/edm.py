"""The EDM (Karras et al.) objective of Cosmos-1.

Counterpart of diffusion_pipe_tpu/training/edm.py. sigma = exp(z), z ~
N(0, 1) (log-normal), x_t = x + sigma n; the network is preconditioned
with the EDM scalings at sigma_data 0.5:

  c_skip = sd^2 / (sigma^2 + sd^2)     c_out = sigma sd / sqrt(sigma^2 + sd^2)
  c_in = 1 / sqrt(sigma^2 + sd^2)      c_noise = log(sigma) / 4

The prediction c_skip x_t + c_out F(c_in x_t, c_noise) is held against the
CLEAN latents with the per-sigma weights (sigma^2 + sd^2) / (sigma sd)^2.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SIGMA_DATA = 0.5


def edm_scalings(sigma: torch.Tensor, sigma_data: float = SIGMA_DATA):
    """(c_skip, c_out, c_in, c_noise) of sigma."""
    denom = torch.sqrt(sigma ** 2 + sigma_data ** 2)
    c_skip = sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2)
    c_out = sigma * sigma_data / denom
    c_in = 1.0 / denom
    c_noise = torch.log(sigma) / 4.0
    return c_skip, c_out, c_in, c_noise


def per_sigma_loss_weights(sigma: torch.Tensor, sigma_data: float = SIGMA_DATA):
    return (sigma ** 2 + sigma_data ** 2) / (sigma * sigma_data) ** 2


def sample_sigma(batch_size: int, generator: Optional[torch.Generator] = None,
                 quantile: Optional[float] = None, device=None) -> torch.Tensor:
    """[B] f32 sigma = exp(z): z ~ N(0, 1) from the generator, or with a
    quantile z = the normal's inverse CDF at it (torch.special.ndtri)."""
    if quantile is not None:
        z = torch.special.ndtri(torch.full((batch_size,), float(quantile), dtype=torch.float64))
        z = z.to(device=device, dtype=torch.float32)
    else:
        z = torch.randn((batch_size,), generator=generator, dtype=torch.float32, device=device)
    return torch.exp(z)


def edm_noise(latents: torch.Tensor, generator: Optional[torch.Generator] = None,
              quantile: Optional[float] = None, noise: Optional[torch.Tensor] = None,
              sigma: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(c_in x_t, x_t, c_noise, sigma) for f32 latents [B, ...]: sigma and
    then the noise drawn from the generator, unless given (the tests pass
    the JAX package's draws)."""
    b = latents.shape[0]
    if sigma is None:
        sigma = sample_sigma(b, generator, quantile, device=latents.device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                            device=latents.device)
    sigma = sigma.to(latents.device, torch.float32)
    exp = (b,) + (1,) * (latents.dim() - 1)
    x_t = latents + sigma.reshape(exp) * noise.to(latents.device, torch.float32)
    _, _, c_in, c_noise = edm_scalings(sigma)
    return x_t * c_in.reshape(exp), x_t, c_noise, sigma
