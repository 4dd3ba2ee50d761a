"""Optimizers, counterpart of diffusion_pipe_tpu/training/optimizers.py.

Ported: `adamw8bit` (int8 moments, signed linear absmax per block of 256 --
the JAX package's scheme, not bitsandbytes' dynamic map), plain `adamw`, and
the learning-rate schedules. Both follow the optax chain of the JAX package:
Adam direction, then `+ weight_decay * p` for parameters with ndim > 1, then
`* -lr(step)`, and the update is added in f32 and cast back to the
parameter's dtype. `get_optimizer` returns a factory that builds the
optimizer once the trainable parameters exist.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Union

import torch

BLOCK = 256

Schedule = Union[float, Callable[[int], float]]


def quantize_blockwise(x: torch.Tensor):
    """Symmetric absmax int8 per block of BLOCK elements of x flattened.
    Returns (q int8 [n_blocks, BLOCK], scale f32 [n_blocks, 1])."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blockwise(q, scale, shape, numel) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:numel].reshape(shape)


def _lr_at(lr: Schedule, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


def _apply_update(p: torch.Tensor, update: torch.Tensor, lr: float,
                  weight_decay: float) -> None:
    if weight_decay and p.dim() > 1:
        update = update + weight_decay * p.float()
    p.copy_((p.float() + update * -lr).to(p.dtype))


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with int8 blockwise-quantized moments (2 bytes a parameter plus
    one f32 scale per 256). `stable` clips the update RMS to 1 (StableAdamW)."""

    def __init__(self, params, lr: Schedule = 1e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, stable: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, stable=stable))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                g = torch.zeros_like(p, dtype=torch.float32) if p.grad is None \
                    else p.grad.float()
                st = self.state[p]
                if not st:
                    zq, zs = quantize_blockwise(torch.zeros_like(g))
                    st.update(step=0, m_q=zq, m_scale=zs,
                              v_q=zq.clone(), v_scale=zs.clone())
                lr = _lr_at(group["lr"], st["step"])
                st["step"] += 1
                count = st["step"]
                m = dequantize_blockwise(st["m_q"], st["m_scale"], g.shape, g.numel())
                v = dequantize_blockwise(st["v_q"], st["v_scale"], g.shape, g.numel())
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                mhat = m / (1 - b1 ** count)
                vhat = v / (1 - b2 ** count)
                update = mhat / (torch.sqrt(vhat) + group["eps"])
                if group["stable"]:
                    rms = torch.sqrt(torch.mean(update * update))
                    update = update / torch.clamp(rms, min=1.0)
                st["m_q"], st["m_scale"] = quantize_blockwise(m)
                st["v_q"], st["v_scale"] = quantize_blockwise(v)
                _apply_update(p, update, lr, group["weight_decay"])
        return loss


class AdamW(torch.optim.Optimizer):
    """AdamW as optax.adamw (eps outside the sqrt, decoupled weight decay on
    ndim > 1). Moments are f32 whatever the parameter dtype."""

    def __init__(self, params, lr: Schedule = 1e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                g = torch.zeros_like(p, dtype=torch.float32) if p.grad is None \
                    else p.grad.float()
                st = self.state[p]
                if not st:
                    st.update(step=0, mu=torch.zeros_like(g), nu=torch.zeros_like(g))
                lr = _lr_at(group["lr"], st["step"])
                st["step"] += 1
                count = st["step"]
                st["mu"].mul_(b1).add_(g, alpha=1 - b1)
                st["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = st["mu"] / (1 - b1 ** count)
                vhat = st["nu"] / (1 - b2 ** count)
                _apply_update(p, mhat / (torch.sqrt(vhat) + group["eps"]), lr,
                              group["weight_decay"])
        return loss


# --- schedules -----------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    return lambda c: init + (end - init) * min(c, steps) / steps


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    def f(c):
        cosine = 0.5 * (1 + math.cos(math.pi * min(c, steps) / steps))
        return init * ((1 - alpha) * cosine + alpha)
    return f


def build_lr_schedule(config: Dict[str, Any], base_lr: float) -> Schedule:
    """`lr_scheduler` = constant | linear | cosine, with linear warmup over
    `warmup_steps`; `force_constant_lr` pins a flat LR. The linear/cosine
    horizon is config['_total_steps']. Returns a float or f(step) -> lr."""
    if "force_constant_lr" in config:
        return float(config["force_constant_lr"])
    sched_type = str(config.get("lr_scheduler", "constant"))
    total = max(1, int(config.get("_total_steps", 0)))
    if sched_type == "constant":
        main: Schedule = base_lr
    elif sched_type == "linear":
        main = _linear(base_lr, 0.0, total)
    elif sched_type == "cosine":
        main = _cosine(base_lr, total, 1e-6 / base_lr if base_lr else 0.0)
    else:
        raise NotImplementedError(f"Unknown lr_scheduler: {sched_type}")
    warmup = int(config.get("warmup_steps", 0))
    if warmup <= 0:
        return main
    warm = _linear(base_lr / warmup, base_lr, warmup)
    return lambda c: warm(c) if c < warmup else _lr_at(main, c - warmup)


def get_optimizer(config: Dict[str, Any]) -> Callable:
    """Factory for config['optimizer']: call it with the trainable parameters."""
    ocfg = dict(config.get("optimizer", {"type": "adamw"}))
    otype = ocfg.get("type", "adamw").lower()
    lr = float(ocfg.get("lr", 1e-4))
    schedule = build_lr_schedule(config, lr)
    betas = list(ocfg.get("betas", [0.9, 0.999]))
    if "beta2_half_life" in ocfg:
        betas = [betas[0], math.exp(math.log(0.5) / float(ocfg["beta2_half_life"]))]
    wd = float(ocfg.get("weight_decay", 0.01))
    eps = float(ocfg.get("eps", 1e-8))
    if ocfg.get("gradient_release") or ocfg.get("stochastic_rounding"):
        raise NotImplementedError("gradient_release / stochastic_rounding are not ported yet")
    if otype in ("adamw", "adamw_optimi", "adamw_kahan"):
        return functools.partial(AdamW, lr=schedule, betas=betas, eps=eps, weight_decay=wd)
    if otype in ("adamw8bit", "adamw8bitkahan"):
        return functools.partial(
            AdamW8bit, lr=schedule, betas=betas, eps=eps, weight_decay=wd,
            stable=bool(ocfg.get("stable", otype == "adamw8bitkahan")))
    raise NotImplementedError(f"optimizer type {otype!r} is not ported yet")
