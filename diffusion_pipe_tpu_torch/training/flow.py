"""Timestep sampling for flow matching, counterpart of
diffusion_pipe_tpu/training/flow.py.

Closed-form inverse-CDF sampling with an explicit torch.Generator; min_t and
max_t truncate the post-shift distribution exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..common import get_lin_function, time_shift


@dataclasses.dataclass(frozen=True)
class TimestepDistribution:
    """method: 'logit_normal' or 'uniform'; sigmoid_scale scales the normal
    draw before the sigmoid; shift is the discrete shift s*t / (1 + (s-1)*t);
    flux_shift the resolution-dependent one; min_t/max_t truncate."""

    method: str = "logit_normal"
    sigmoid_scale: float = 1.0
    shift: Optional[float] = None
    flux_shift: bool = False
    min_t: float = 0.0
    max_t: float = 1.0

    @staticmethod
    def from_model_config(model_config: dict) -> "TimestepDistribution":
        return TimestepDistribution(
            method=model_config.get("timestep_sample_method", "logit_normal"),
            sigmoid_scale=float(model_config.get("sigmoid_scale", 1.0)),
            shift=model_config.get("shift", None),
            flux_shift=bool(model_config.get("flux_shift", False)),
            min_t=float(model_config.get("min_t", 0.0)),
            max_t=float(model_config.get("max_t", 1.0)),
        )


def _base_cdf(dist: TimestepDistribution, t: float) -> float:
    t = min(max(t, 1e-7), 1 - 1e-7)
    if dist.method == "logit_normal":
        z = math.log(t / (1 - t)) / dist.sigmoid_scale
        return 0.5 * math.erfc(-z / math.sqrt(2.0))
    if dist.method == "uniform":
        return t
    raise NotImplementedError(dist.method)


def _base_icdf(dist: TimestepDistribution, q: torch.Tensor) -> torch.Tensor:
    q = q.clamp(1e-7, 1 - 1e-7)
    if dist.method == "logit_normal":
        return torch.sigmoid(torch.special.ndtri(q) * dist.sigmoid_scale)
    if dist.method == "uniform":
        return q
    raise NotImplementedError(dist.method)


def apply_time_shift(dist: TimestepDistribution, t, image_seq_len: Optional[int] = None):
    """Apply the configured (resolution-dependent) time shift."""
    if dist.shift is not None:
        s = dist.shift
        return (t * s) / (1 + (s - 1) * t)
    if dist.flux_shift:
        if image_seq_len is None:
            raise ValueError("flux_shift requires image_seq_len")
        mu = get_lin_function(y1=0.5, y2=1.15)(image_seq_len)
        return time_shift(mu, 1.0, t)
    return t


def _inverse_time_shift(dist: TimestepDistribution, t_shifted: float,
                        image_seq_len: Optional[int] = None) -> float:
    if dist.shift is not None:
        s = dist.shift
        return t_shifted / (s - (s - 1) * t_shifted)
    if dist.flux_shift:
        if image_seq_len is None:
            raise ValueError("flux_shift requires image_seq_len")
        mu = get_lin_function(y1=0.5, y2=1.15)(image_seq_len)
        return 1.0 / (1.0 + math.exp(mu) * (1.0 / t_shifted - 1.0))
    return t_shifted


def sample_timesteps(batch_size: int, dist: TimestepDistribution = TimestepDistribution(),
                     generator: Optional[torch.Generator] = None,
                     quantile: Optional[float] = None,
                     image_seq_len: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Per-example t in (0, 1), f32 [batch_size]. With `quantile` set (eval),
    t is the deterministic icdf of that quantile within the truncated range."""
    qmin = (_base_cdf(dist, _inverse_time_shift(dist, dist.min_t, image_seq_len))
            if dist.min_t > 0.0 else 0.0)
    qmax = (_base_cdf(dist, _inverse_time_shift(dist, dist.max_t, image_seq_len))
            if dist.max_t < 1.0 else 1.0)
    if quantile is not None:
        q = torch.full((batch_size,), qmin + (qmax - qmin) * quantile,
                       dtype=torch.float32, device=device)
    else:
        q = qmin + (qmax - qmin) * torch.rand(
            (batch_size,), generator=generator, dtype=torch.float32, device=device)
    return apply_time_shift(dist, _base_icdf(dist, q), image_seq_len=image_seq_len)
