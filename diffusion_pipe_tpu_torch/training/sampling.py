"""Euler flow-matching sampler, counterpart of
diffusion_pipe_tpu/training/sampling.py (diffusers'
FlowMatchEulerDiscreteScheduler, optional classifier-free guidance). It
runs through the training forward, under torch.no_grad(): no graph is
built, no block is checkpointed (models run their blocks under checkpoint
only where gradients are on), so nothing is recorded for a recompute and
the adapters run without dropout.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def flow_sigmas(num_steps: int, shift: Optional[float] = None,
                device=None) -> torch.Tensor:
    """[num_steps + 1] f32: linspace 1 -> 1/num_steps, optionally shifted to
    s*sig / (1 + (s-1)*sig), then a terminal 0."""
    sigmas = torch.linspace(1.0, 1.0 / num_steps, num_steps, dtype=torch.float32,
                            device=device)
    if shift:
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    return torch.cat([sigmas, torch.zeros(1, dtype=torch.float32, device=device)])


@torch.no_grad()
def euler_flow_sample(velocity_fn: Callable, latents_shape: Sequence[int],
                      generator: Optional[torch.Generator] = None, num_steps: int = 20,
                      guidance_scale: float = 1.0,
                      uncond_velocity_fn: Optional[Callable] = None,
                      shift: Optional[float] = None, noise: Optional[torch.Tensor] = None,
                      device=None) -> torch.Tensor:
    """velocity_fn(x, t [B]) -> v, the model's training output (v = noise -
    data). Starts from `noise` when given (the tests pass the JAX package's
    draw), else from N(0, 1) of `generator` on `device`, and takes Euler
    steps x <- x + (sigma_{i+1} - sigma_i) v; with guidance_scale != 1 and
    uncond_velocity_fn, v = vu + guidance_scale (v - vu). f32 latents."""
    if noise is not None:
        x = noise.to(device=device, dtype=torch.float32)
    else:
        x = torch.randn(tuple(latents_shape), generator=generator, dtype=torch.float32,
                        device=device)
    sigmas = flow_sigmas(num_steps, shift, device=x.device)
    b = x.shape[0]
    for i in range(num_steps):
        t = sigmas[i].expand(b)
        v = velocity_fn(x, t).float()
        if guidance_scale != 1.0 and uncond_velocity_fn is not None:
            vu = uncond_velocity_fn(x, t).float()
            v = vu + guidance_scale * (v - vu)
        x = x + (sigmas[i + 1] - sigmas[i]) * v
    return x
