"""Automagic, counterpart of diffusion_pipe_tpu/training/automagic.py: an
Adafactor second moment (factored over the last two axes of a matrix, full
for a vector), the update's RMS clipped to clip_threshold, and a learning
rate per element, bumped up by lr_bump where the update's sign agrees with
the last step's and down where it flips, clipped to [min_lr, max_lr] and
stored blockwise as int8 (optimizers.quantize_blockwise, as adamw8bit's
moments). No schedule: the per-element rates are the step sizes.

The sign flips make the trajectory chaotic: a last-bit difference in an
update can flip one element's sign and move its rate by 2 * lr_bump.
"""

from __future__ import annotations

import torch

from .optimizers import _UpdateRule, dequantize_blockwise, quantize_blockwise


class Automagic(_UpdateRule):
    jax_layout_math = True  # the factored moment's rows are the JAX kernel's

    def __init__(self, params, lr_bump: float = 3e-6, min_lr: float = 1e-7,
                 max_lr: float = 1e-3, eta: float = 1e-5, beta2: float = 0.999,
                 eps: float = 1e-30, clip_threshold: float = 1.0, weight_decay: float = 0.0,
                 **kw):
        super().__init__(params, dict(lr_bump=lr_bump, min_lr=min_lr, max_lr=max_lr, eta=eta,
                                      beta2=beta2, eps=eps, clip_threshold=clip_threshold,
                                      weight_decay=weight_decay), **kw)

    def _update(self, p, g, st, group):
        b2 = group["beta2"]
        g = g.float()
        factored = g.dim() >= 2
        if not st:
            if factored:
                st["row"] = torch.zeros(g.shape[:-1], device=g.device)
                st["col"] = torch.zeros(g.shape[:-2] + g.shape[-1:], device=g.device)
            else:
                st["full"] = torch.zeros_like(g)
            st["polarity"] = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
            st["lr_q"], st["lr_scale"] = quantize_blockwise(torch.full_like(g, group["eta"]))
        sq = g * g + group["eps"]
        if factored:
            st["row"] = b2 * st["row"] + (1 - b2) * sq.mean(-1)
            st["col"] = b2 * st["col"] + (1 - b2) * sq.mean(-2)
            r = torch.rsqrt(st["row"] / st["row"].mean(-1, keepdim=True))[..., None]
            c = torch.rsqrt(st["col"])[..., None, :]
            update = g * r * c
        else:
            st["full"] = b2 * st["full"] + (1 - b2) * sq
            update = g * torch.rsqrt(st["full"])
        rms = torch.sqrt(torch.sum(update * update)) / (update.numel() ** 0.5)
        update = update / torch.clamp(rms / group["clip_threshold"], min=1.0)

        positive = update > 0
        agree = positive == st["polarity"]
        lr = dequantize_blockwise(st["lr_q"], st["lr_scale"], g.shape, g.numel())
        bump = group["lr_bump"]
        lr = torch.clamp(torch.where(agree, lr + bump, lr - bump), group["min_lr"],
                         group["max_lr"])
        step = update * lr
        if group["weight_decay"]:
            step = step + group["weight_decay"] * lr * p.float()
        st["polarity"] = positive
        st["lr_q"], st["lr_scale"] = quantize_blockwise(lr)
        st["avg_lr"] = lr.mean()
        return -step
