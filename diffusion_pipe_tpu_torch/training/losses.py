"""Loss functions, counterpart of diffusion_pipe_tpu/training/losses.py.

Masked MSE / Huber / smooth-L1 computed in float32 regardless of the compute
dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def _elementwise_loss(output, target, loss_type: str = "mse",
                      huber_delta: float = 1.0, smooth_l1_beta: float = 1.0):
    diff = output.float() - target.float()
    if loss_type == "mse":
        return diff * diff
    ad = diff.abs()
    if loss_type == "huber":
        return torch.where(ad < huber_delta, 0.5 * diff * diff,
                           huber_delta * (ad - 0.5 * huber_delta))
    if loss_type == "smooth_l1":
        return torch.where(ad < smooth_l1_beta, 0.5 * diff * diff / smooth_l1_beta,
                           ad - 0.5 * smooth_l1_beta)
    raise NotImplementedError(loss_type)


def masked_loss(output, target, mask: Optional[torch.Tensor] = None,
                loss_type: str = "mse", huber_delta: float = 1.0,
                smooth_l1_beta: float = 1.0,
                per_example_weights: Optional[torch.Tensor] = None):
    """Elementwise loss times the mask (no renormalisation by mask density),
    optionally weighted per example, averaged over every element."""
    loss = _elementwise_loss(output, target, loss_type, huber_delta, smooth_l1_beta)
    if mask is not None and mask.numel() > 0:
        loss = loss * mask.float().expand_as(loss)
    if per_example_weights is not None:
        w = per_example_weights.float()
        loss = loss * w.reshape(w.shape + (1,) * (loss.dim() - 1))
    return loss.mean()


def loss_config_from_model_config(config: dict) -> dict:
    """Loss-type kwargs from a model config ('huber_delta' / 'smooth_l1_beta')."""
    if "huber_delta" in config:
        return {"loss_type": "huber", "huber_delta": float(config["huber_delta"])}
    if "smooth_l1_beta" in config:
        return {"loss_type": "smooth_l1",
                "smooth_l1_beta": float(config["smooth_l1_beta"])}
    return {"loss_type": "mse"}
