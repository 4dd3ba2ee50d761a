"""Optimizers, counterpart of diffusion_pipe_tpu/training/optimizers.py.

`adamw8bit` (int8 moments, signed linear absmax per block of 256 -- the
JAX package's scheme, not bitsandbytes' dynamic map), `adamw`,
`stableadamw` (AdamW with the update's RMS clipped to 1 before the weight
decay) and `sgd` (optax.trace momentum, optionally Nesterov) follow the
optax chain of the JAX package: the direction, then `+ weight_decay * p`
for parameters with ndim > 1, then `* -lr(step)`, and `apply_update` adds
the result to the parameter. `automagic` (training/automagic.py), `muon` /
`adamuon` / `normuon` (training/muon.py) and `genericoptim` / `adafactor` /
`adagrad` (training/generic_optim.py) port the JAX package's own
transforms. Names the JAX package resolves in optax by name have no
counterpart here and raise NotImplementedError. The
schedule counts from a parameter state's `schedule_offset` (0 unless
--reset_optimizer_params restarted it; the bias corrections keep counting).

adamw8bit does its update math in f32. adamw follows optax.adamw's dtypes:
its moments start in the parameter's dtype (bf16 moments for a bf16
parameter) and every operation takes the dtype that promotion gives it, so
f32 gradients of a bf16 parameter turn the moments f32. A Python scalar
meets a tensor as jnp meets it -- rounded to the tensor's dtype first
(`_weak`) -- and the bias corrections are computed in f32 as optax computes
them. `get_optimizer` returns a factory that builds the optimizer once the
trainable parameters exist.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .. import interop
from ..common import weak_scalar as _weak
from ..ops.quant import sr_add_

BLOCK = 256
# seed of a stochastically rounded update: step * SR_SEED_STRIDE + tensor index
SR_SEED_STRIDE = 1000003

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


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in f32, as optax.tree.bias_correction computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def apply_update(p: torch.Tensor, u: torch.Tensor, sr_seed: Optional[int] = None,
                 ok: Optional[torch.Tensor] = None) -> None:
    """p <- p + u in place, as optax.apply_updates: the sum in the promoted
    dtype, cast to p's. With sr_seed, a bf16 p instead becomes
    SR(f32(p) + f32(u)) through K4 (ops/quant.py), the JAX package's
    `_apply_updates` with stochastic rounding; other dtypes add as before.
    ok: a 0-dim bool tensor; where it is false the update is masked, as the
    JAX step masks the update of a tensor whose gradient is not finite. The
    mask is -0.0, not 0: x + (-0.0) is x for every x, the sign of a zero
    included, so a masked tensor keeps its bits (also through K4)."""
    if ok is not None:
        u = torch.where(ok, u, torch.tensor(-0.0, dtype=u.dtype, device=u.device))
    if sr_seed is not None and p.dtype == torch.bfloat16:
        sr_add_(p, u.contiguous(), sr_seed)  # K4 reads u as laid out in memory
    else:
        p.copy_(p + u)


def _inverse(perm: tuple) -> tuple:
    return tuple(perm.index(i) for i in range(len(perm)))


def path_scales(names: Sequence[str], scales: Dict[str, float]) -> list:
    """The JAX package's scale_updates_by_path for the port's names: each
    parameter's factor is that of the last `scales` key found in its path,
    the name as the JAX tree path ("params/" + its parts joined by "/",
    without the block indices of the port's unstacked blocks), else 1."""
    out = []
    for name in names:
        joined = "/".join(["params"] + [p for p in name.split(".") if not p.isdigit()])
        factor = 1.0
        for sub, f in scales.items():
            if sub in joined:
                factor = float(f)
        out.append(factor)
    return out


class _UpdateRule(torch.optim.Optimizer):
    """The loop every optimizer shares: `_update` gives each parameter's
    update, `apply_update` adds it. With parameter names, an optimizer
    whose math depends on the layout (`jax_layout_math`: factored moments,
    orthogonalization, projections) sees each tensor as the JAX package
    lays it out (a view permuted by interop.jax_layout, the update permuted
    back), and update_scales (lr_scales) multiply the updates."""

    jax_layout_math = False

    def __init__(self, params, defaults, names: Optional[Sequence[str]] = None,
                 lr_scales: Optional[Dict[str, float]] = None):
        super().__init__(params, defaults)
        flat = [p for g in self.param_groups for p in g["params"]]
        names = list(names) if names is not None else [None] * len(flat)
        self.layouts = [interop.jax_layout(n, p.dim())
                        if self.jax_layout_math and n is not None else None
                        for n, p in zip(names, flat)]
        self.update_scales = (path_scales(names, lr_scales)
                              if lr_scales and names[0] is not None else None)

    def _update(self, p, g, st, group) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Sequence[Optional[torch.Tensor]]] = None,
             sr_step: Optional[int] = None,
             finite: Optional[Sequence[torch.Tensor]] = None):
        """grads: one gradient (or None, read as zeros) per parameter in the
        order of the param groups, in place of each p.grad -- the trainer
        hands in f32 gradients of bf16 parameters this way, which p.grad
        cannot hold. sr_step: round bf16 parameters stochastically, the
        tensor at index i seeded with sr_step * SR_SEED_STRIDE + i (int32,
        wrapping). The JAX package seeds with the same formula, but indexes
        the leaves of its scanned block stacks, and its TPU bits cannot be
        reproduced: the two agree in distribution, not bit for bit.
        finite: one 0-dim bool tensor per parameter; a parameter whose flag
        is false keeps its value (its state still steps, as in the JAX
        step, on the zeroed gradient the trainer hands in)."""
        loss = None if closure is None else closure()
        i = 0
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if grads is None else grads[i]
                if g is None:
                    g = torch.zeros_like(p)
                perm = self.layouts[i]
                if perm is None:
                    u = self._update(p, g, self.state[p], group)
                else:
                    u = self._update(p.permute(perm), g.permute(perm), self.state[p],
                                     group).permute(_inverse(perm))
                if self.update_scales is not None and self.update_scales[i] != 1.0:
                    u = _weak(self.update_scales[i], u) * u
                seed = None if sr_step is None else (sr_step * SR_SEED_STRIDE + i) & 0xFFFFFFFF
                apply_update(p, u, seed, None if finite is None else finite[i])
                i += 1
        return loss


class AdamW8bit(_UpdateRule):
    """AdamW with int8 blockwise-quantized moments (2 bytes a parameter plus
    one f32 scale per 256). `stable` clips the update RMS to 1 (StableAdamW).
    The update is f32."""

    def __init__(self, params, lr: Schedule = 1e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, stable: bool = False,
                 **kw):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, stable=stable), **kw)

    def _update(self, p, g, st, group):
        b1, b2 = group["betas"]
        g = g.float()
        if not st:
            zq, zs = quantize_blockwise(torch.zeros_like(g))
            st.update(step=0, m_q=zq, m_scale=zs, v_q=zq.clone(), v_scale=zs.clone())
        lr = _lr_at(group["lr"], st["step"] - st.get("schedule_offset", 0))
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
            update = clip_update_rms(update)
        st["m_q"], st["m_scale"] = quantize_blockwise(m)
        st["v_q"], st["v_scale"] = quantize_blockwise(v)
        if group["weight_decay"] and p.dim() > 1:
            update = update + group["weight_decay"] * p.float()
        return update * -lr


class AdamW(_UpdateRule):
    """AdamW as optax.adamw (eps outside the sqrt, decoupled weight decay on
    ndim > 1), in optax's dtypes: see the module docstring. `stable`
    (stableadamw): the Adam direction's RMS clipped to at most 1 before the
    weight decay, as the JAX package's _clip_update_rms."""

    def __init__(self, params, lr: Schedule = 1e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, stable: bool = False,
                 **kw):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, stable=stable), **kw)

    def _update(self, p, g, st, group):
        b1, b2 = group["betas"]
        if not st:
            st.update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
        lr = _lr_at(group["lr"], st["step"] - st.get("schedule_offset", 0))
        st["step"] += 1
        count = st["step"]
        mu, nu = st["mu"], st["nu"]
        # optax's (1 - decay) * g**order + decay * moment, operand by operand
        mu = _weak(1 - b1, g) * g + _weak(b1, mu) * mu
        nu = _weak(1 - b2, g) * (g * g) + _weak(b2, nu) * nu
        st["mu"], st["nu"] = mu, nu
        mhat = mu / _weak(_bias_correction(b1, count), mu)
        vhat = nu / _weak(_bias_correction(b2, count), nu)
        root = torch.sqrt(vhat)
        update = mhat / (root + _weak(group["eps"], root))
        if group["stable"]:
            update = clip_update_rms(update)
        if group["weight_decay"] and p.dim() > 1:
            update = update + _weak(group["weight_decay"], p) * p
        return _weak(-lr, update) * update


def clip_update_rms(u: torch.Tensor) -> torch.Tensor:
    """u / max(1, rms(u)), the RMS over u's f32 image, cast back to u's
    dtype (the JAX package's _clip_update_rms)."""
    rms = torch.sqrt(torch.mean(u.float() ** 2))
    return (u.float() / torch.clamp(rms, min=1.0)).to(u.dtype)


class SGD(_UpdateRule):
    """optax.sgd as the JAX package chains it: optax.trace(momentum,
    nesterov) when momentum is set (its trace in the parameter's dtype at
    first, then the promoted one), `+ weight_decay * p` on ndim > 1 when
    weight_decay is set, `* -lr(step)`."""

    def __init__(self, params, lr: Schedule = 1e-4, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0, **kw):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov,
                                      weight_decay=weight_decay), **kw)

    def _update(self, p, g, st, group):
        if not st:
            st.update(step=0)
            if group["momentum"]:
                st["trace"] = torch.zeros_like(p)
        lr = _lr_at(group["lr"], st["step"] - st.get("schedule_offset", 0))
        st["step"] += 1
        update = g
        mom = group["momentum"]
        if mom:
            trace = g + _weak(mom, st["trace"]) * st["trace"]
            update = g + _weak(mom, trace) * trace if group["nesterov"] else trace
            st["trace"] = trace
        if group["weight_decay"] and p.dim() > 1:
            update = update + _weak(group["weight_decay"], p) * p
        return _weak(-lr, update) * update


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


def get_optimizer(config: Dict[str, Any],
                  lr_scales: Optional[Dict[str, float]] = None) -> Callable:
    """Factory for config['optimizer']: call it with the trainable
    parameters (and their names, which lr_scales -- per-module LR factors
    by path substring, from pipeline.lr_scale_map -- and the layout-aware
    optimizers read). With gradient_release and GAS > 1 the betas (and
    momentum) become b ** (1 / GAS): one step a micro-batch keeps the
    moments' half-life in samples."""
    ocfg = dict(config.get("optimizer", {"type": "adamw"}))
    otype = ocfg.get("type", "adamw").lower()
    lr = float(ocfg.get("lr", 1e-4))
    schedule = build_lr_schedule(config, lr)
    betas = list(ocfg.get("betas", [0.9, 0.999]))
    if "beta2_half_life" in ocfg:
        betas = [betas[0], math.exp(math.log(0.5) / float(ocfg["beta2_half_life"]))]
    wd = float(ocfg.get("weight_decay", 0.01))
    eps = float(ocfg.get("eps", 1e-8))
    # `stochastic_rounding` is read by the caller and handed to make_train_step
    gas = int(config.get("gradient_accumulation_steps", 1))
    if ocfg.get("gradient_release") and gas > 1:
        betas = [b ** (1.0 / gas) for b in betas]
        if "momentum" in ocfg:
            ocfg["momentum"] = float(ocfg["momentum"]) ** (1.0 / gas)
    cls, kw = _build(otype, ocfg, schedule, betas, wd, eps, lr)

    def factory(params, names: Optional[Sequence[str]] = None):
        return cls(params, names=names, lr_scales=lr_scales, **kw)

    return factory


def _build(otype, ocfg, schedule, betas, wd, eps, lr):
    """(optimizer class, its keyword arguments) for optimizer.type."""
    if otype in ("adamw", "adamw_optimi", "adamw_kahan", "stableadamw"):
        return AdamW, dict(lr=schedule, betas=betas, eps=eps, weight_decay=wd,
                           stable=otype == "stableadamw")
    if otype in ("adamw8bit", "adamw8bitkahan"):
        return AdamW8bit, dict(lr=schedule, betas=betas, eps=eps, weight_decay=wd,
                               stable=bool(ocfg.get("stable", otype == "adamw8bitkahan")))
    if otype == "sgd":
        return SGD, dict(lr=schedule, momentum=float(ocfg.get("momentum", 0.0)),
                         nesterov=bool(ocfg.get("nesterov", False)), weight_decay=wd)
    if otype in ("muon", "adamuon", "normuon"):
        from .muon import Muon

        return Muon, dict(lr=schedule, momentum=float(ocfg.get("momentum", 0.95)),
                          nesterov=bool(ocfg.get("nesterov", True)), weight_decay=wd,
                          polar_express=bool(ocfg.get("polar_express", False)))
    if otype in ("genericoptim", "generic", "adafactor", "adagrad"):
        from .generic_optim import GenericOptim

        second = {"adafactor": "factored", "adagrad": "adagrad"}.get(
            otype, ocfg.get("second_moment_type", "ema"))
        return GenericOptim, dict(
            lr=schedule, momentum_type=ocfg.get("momentum_type", "ema"),
            second_moment_type=second, betas=(betas[0], betas[1]), eps=eps,
            correct_bias=bool(ocfg.get("correct_bias", True)), rank=int(ocfg.get("rank", 0)),
            proj_type=ocfg.get("proj_type", "svd"),
            update_proj_gap=int(ocfg.get("update_proj_gap", 200)), weight_decay=wd)
    if otype == "automagic":
        from .automagic import Automagic

        return Automagic, dict(
            lr_bump=float(ocfg.get("lr_bump", 3e-6)), min_lr=float(ocfg.get("min_lr", 1e-7)),
            max_lr=float(ocfg.get("max_lr", 1e-3)), eta=float(ocfg.get("eta", lr)), eps=eps,
            weight_decay=float(ocfg.get("weight_decay", 0.0)))
    # the JAX package looks any other name up in optax / optax.contrib; none
    # of those has a counterpart here whose update is shown to equal optax's
    raise NotImplementedError(f"optimizer type {otype!r} is not ported (the JAX package "
                              "resolves it in optax by name)")
