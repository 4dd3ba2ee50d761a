"""Shared building blocks: LoRA-aware linear, norms, embeddings, RoPE.

Counterpart of diffusion_pipe_tpu/models/layers.py (the parts the Flux
and Wan slices use), plus Wan's patch embedding. Parameter names follow the JAX package so interop.py maps one
onto the other:

- LoraDense.weight is torch's [out, in] (the Flax `kernel` transposed);
  `bias` [out]; `lora_a` [in, rank] and `lora_b` [rank, out] keep the Flax
  layout, so the optimizer's 256-element quantization blocks cover the same
  elements in both packages.
- lora_a is STORED uniform in [0, 2*bound) and shifted by -bound in the
  forward, as in the JAX package: weight decay acts on the stored value, so
  the stored convention decides the training trajectory.
- RMSNorm.scale [dim].
- PatchEmbed3d.weight is torch's Conv3d layout [out, in, kt, kh, kw] (the
  Flax Conv `kernel` [kt, kh, kw, in, out] transposed).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Flax's lecun_normal draws a normal truncated to [-2, 2] and rescales it by
# this constant so the result has the requested variance.
_TRUNC_NORMAL_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """In place: truncated-normal init with variance 1/fan_in (flax lecun_normal).

    Drawn in f32 and cast, so a bf16 weight gets the same distribution.
    """
    std = math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.copy_(tmp.mul_(std))


class LoraDense(nn.Module):
    """y = x W^T + b + (alpha/rank) * (x (A - bound)) B, computed in `dtype`.

    A is stored uniform in [0, 2*bound), bound = sqrt(6/in) (kaiming-uniform
    like PEFT once shifted), B zeros, so training starts at the base model.
    rank=0 disables LoRA.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 lora_rank: int = 0, lora_alpha: float = 0.0,
                 lora_dropout: float = 0.0, lora_dtype=torch.float32):
        super().__init__()
        if lora_dropout > 0.0:
            raise NotImplementedError("LoRA dropout is not ported yet")
        self.in_features = in_features
        self.features = features
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.weight = nn.Parameter(torch.empty(features, in_features, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.empty(features, dtype=param_dtype))
                     if use_bias else None)
        if lora_rank > 0:
            self.lora_bound = math.sqrt(6.0 / in_features)
            self.lora_scaling = lora_alpha / lora_rank
            self.lora_a = nn.Parameter(torch.empty(in_features, lora_rank, dtype=lora_dtype))
            self.lora_b = nn.Parameter(torch.empty(lora_rank, features, dtype=lora_dtype))
        else:
            self.lora_a = self.lora_b = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            self.bias.zero_()
        if self.lora_a is not None:
            tmp = torch.empty(self.lora_a.shape, dtype=torch.float32,
                              device=self.lora_a.device)
            tmp.uniform_(0.0, 2 * self.lora_bound, generator=generator)
            self.lora_a.copy_(tmp)
            self.lora_b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.linear(h, self.weight.to(self.dtype), bias)
        if self.lora_a is not None:
            a = (self.lora_a - self.lora_bound).to(self.dtype)
            y = y + self.lora_scaling * ((h @ a) @ self.lora_b.to(self.dtype))
        return y


class RMSNorm(nn.Module):
    """RMSNorm over the last dim, computed in float32, cast back."""

    def __init__(self, dim: int, eps: float = 1e-6, param_dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last dim in float32, with an optional affine
    scale and bias (taken in float32), cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float() + bias.float()
    return y.to(x.dtype)


class PatchEmbed3d(nn.Module):
    """Conv3d with kernel = stride = patch over [B, C, F, H, W], returning
    the tokens [B, (F/pt)(H/ph)(W/pw), out] in `dtype`. With kernel equal to
    stride the convolution is one product of the flattened patches with the
    flattened kernel, which is how it is computed here."""

    def __init__(self, in_channels: int, features: int, patch: Tuple[int, int, int],
                 dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.patch = tuple(patch)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, *self.patch,
                                               dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, h, w = x.shape
        pt, ph, pw = self.patch
        x = x.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, -1, c * pt * ph * pw)
        return F.linear(x.to(self.dtype), self.weight.flatten(1).to(self.dtype),
                        self.bias.to(self.dtype))


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: x * (1 + scale) + shift, broadcasting [B, D] over seq."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def sinusoidal_timestep_embedding(t: torch.Tensor, dim: int,
                                  max_period: float = 10000.0,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0,
                                  scale: float = 1.0) -> torch.Tensor:
    """diffusers `Timesteps` projection; t [B] already scaled (e.g. *1000)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=t.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = t.float()[:, None] * freqs[None, :] * scale
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedder(nn.Module):
    """sinusoidal -> Linear -> SiLU -> Linear (diffusers TimestepEmbedding)."""

    def __init__(self, hidden_dim: int, freq_dim: int = 256,
                 dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.freq_dim = freq_dim
        self.linear_1 = LoraDense(freq_dim, hidden_dim, dtype=dtype, param_dtype=param_dtype)
        self.linear_2 = LoraDense(hidden_dim, hidden_dim, dtype=dtype, param_dtype=param_dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_timestep_embedding(t, self.freq_dim)
        return self.linear_2(F.silu(self.linear_1(emb)))


class PixArtAlphaTextProjection(nn.Module):
    """pooled text -> Linear -> SiLU -> Linear (diffusers text_embedder)."""

    def __init__(self, in_dim: int, hidden_dim: int, dtype=torch.bfloat16,
                 param_dtype=torch.float32):
        super().__init__()
        self.linear_1 = LoraDense(in_dim, hidden_dim, dtype=dtype, param_dtype=param_dtype)
        self.linear_2 = LoraDense(hidden_dim, hidden_dim, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


def rope_frequencies(ids: torch.Tensor, axes_dim: Sequence[int],
                     theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-axis RoPE tables (cos, sin), each [S, sum(axes_dim) // 2], from
    position ids [S, n_axes]; every axis gives axes_dim[i] // 2 frequencies."""
    cos_parts, sin_parts = [], []
    for i, d in enumerate(axes_dim):
        half = d // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                              device=ids.device) * 2.0 / d))
        angles = ids[:, i].float()[:, None] * freqs[None, :]
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x[..., 2i], x[..., 2i+1]) of x [B, S, H, D]
    by cos/sin [S, D//2], in float32, cast back (BFL/diffusers flux)."""
    xf = x.float()
    x0 = xf[..., 0::2]
    x1 = xf[..., 1::2]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def remat_spec(config) -> str:
    """`activation_checkpointing` as a remat spec: "" (off) or "full" (each
    block's forward is recomputed in the backward). The JAX package's other
    policies ("dots", "attn", "offload_attn", "unsloth") are not ported yet."""
    ac = config.get("activation_checkpointing", False)
    if not ac:
        return ""
    spec = str(config.get("remat_policy", "full")) if ac is True else str(ac)
    if spec != "full":
        raise NotImplementedError(
            f"activation_checkpointing {spec!r} is not ported yet; use true"
        )
    return spec


def init_module_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Run init_weights on every submodule that has one, in module order."""
    for m in module.modules():
        fn = getattr(m, "init_weights", None)
        if fn is not None:
            fn(generator)
