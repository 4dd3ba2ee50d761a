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
- With int8_matmul, LoraDense also has `kernel_scale` [out] f32 (ones until
  prequantize_int8_ replaces the frozen weight with its int8 image and
  writes the real per-output-channel scales).

The int8 linears (int8_dot, int8_dot_bwd8, int8_pq_dot, int8_pq_dot_bwd8)
follow the JAX functions of the same names operand for operand; their
quantization and rescale are ops/int8_quant.py (H1, H2 on the card). The
JAX per-output-channel reduction over axis -2 of a kernel [in, out] is a
per-row reduction of the port's [out, in] weight, and its per-input-channel
one a per-column reduction.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common import dtype_from_string
from ..ops import flash_attention as fa
from ..ops.int8_quant import int_mm, quant_rows, rescale_i32

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


# --- W8A8 int8 linears ------------------------------------------------------------


def _rows2d(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def _as_quantizable(w: torch.Tensor) -> torch.Tensor:
    """A float weight in a dtype H1 reads: fp8 goes to bf16, which holds
    every fp8 value exactly."""
    return w if w.dtype in (torch.bfloat16, torch.float32) else w.to(torch.bfloat16)


def quantize_kernel_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel absmax int8 image of a weight [out, in]: (w8 int8
    [out, in], scale f32 [out]), the JAX quantize_kernel_int8 of the kernel
    [in, out] transposed."""
    w8, scale = quant_rows(_as_quantizable(w))
    return w8, scale.reshape(-1)


def _int8_forward(x, w8, w_scale):
    """(x8 @ w8^T) * x_scale * w_scale in x's dtype: x [..., in], w8 [out,
    in] int8, w_scale [out] f32 (the JAX _int8pq_fwd_impl, cast to the
    layer's dtype as LoraDense casts it)."""
    x8, x_scale = quant_rows(_rows2d(x))
    y = rescale_i32(int_mm(x8, w8.t()), x_scale, w_scale, x.dtype)
    return y.reshape(*x.shape[:-1], w8.shape[0])


def _zero_like_if(ctx, i, t):
    """The zero cotangent the JAX functions return for a weight input."""
    return torch.zeros_like(t) if ctx.needs_input_grad[i] else None


class _Int8Dot(torch.autograd.Function):
    """int8_dot: dynamic W8A8 product against a float weight [out, in]; the
    backward is straight-through in f32 (dx = g W) with a zero weight
    cotangent, trainable weight or not, as in the JAX package."""

    @staticmethod
    def forward(ctx, x, w):
        w8, w_scale = quantize_kernel_int8(w)
        ctx.save_for_backward(w)
        return _int8_forward(x, w8, w_scale)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        dx = (g.float() @ w.float()).to(g.dtype) if ctx.needs_input_grad[0] else None
        return dx, _zero_like_if(ctx, 1, w)


class _Int8DotBwd8(_Int8Dot):
    """int8_dot_bwd8: int8_dot whose dgrad is an int8 product too, per-row
    cotangent scales times per-input-channel weight scales."""

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, _zero_like_if(ctx, 1, w)
        g8, g_scale = quant_rows(_rows2d(g))
        # per input channel: the rows of w^T [in, out]
        wt8, wt_scale = quant_rows(_as_quantizable(w).t())
        dx = rescale_i32(int_mm(g8, wt8.t()), g_scale, wt_scale, g.dtype)
        return dx.reshape(*g.shape[:-1], w.shape[1]), _zero_like_if(ctx, 1, w)


class _Int8PqDot(torch.autograd.Function):
    """int8_pq_dot: W8A8 product against a pre-quantized weight (w8 [out,
    in] int8, w_scale [out] f32). The dgrad is (g * w_scale) in bf16 times
    w8 in bf16, summed in f32."""

    @staticmethod
    def forward(ctx, x, w8, w_scale):
        ctx.save_for_backward(w8, w_scale)
        return _int8_forward(x, w8, w_scale)

    @staticmethod
    def backward(ctx, g):
        w8, w_scale = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, _zero_like_if(ctx, 2, w_scale)
        gs = (g.float() * w_scale).to(torch.bfloat16)
        if g.dtype == torch.bfloat16:
            # a bf16 product rounds its f32 sum once, as the cast does
            dx = gs @ w8.to(torch.bfloat16)
        else:
            # bf16 x bf16 products are exact in f32
            dx = (gs.float() @ w8.float()).to(g.dtype)
        return dx, None, _zero_like_if(ctx, 2, w_scale)


class _Int8PqDotBwd8(_Int8PqDot):
    """int8_pq_dot_bwd8: int8_pq_dot with an int8 dgrad; the weight's column
    scales fold into the cotangent before its per-row quantization (H1's
    column pre-scale)."""

    @staticmethod
    def backward(ctx, g):
        w8, w_scale = ctx.saved_tensors
        dx = _int8_pq_dgrad8(g, w8, w_scale) if ctx.needs_input_grad[0] else None
        return dx, None, _zero_like_if(ctx, 2, w_scale)


def _int8_pq_dgrad8(g, w8, w_scale):
    """int8_pq_dot_bwd8's dx: (g * w_scale) quantized per row, times w8 as
    int8, rescaled by the rows' scales, in g's dtype."""
    g8, g_scale = quant_rows(_rows2d(g), w_scale)
    # _int_mm wants both operands K-major: a transposed copy of w8 for this
    # call (the contraction runs over its output channels)
    w8t = w8.t().contiguous()
    dx = rescale_i32(int_mm(g8, w8t.t()), g_scale, None, g.dtype)
    return dx.reshape(*g.shape[:-1], w8.shape[1])


int8_dot = _Int8Dot.apply
int8_dot_bwd8 = _Int8DotBwd8.apply
int8_pq_dot = _Int8PqDot.apply
int8_pq_dot_bwd8 = _Int8PqDotBwd8.apply


class LoraDense(nn.Module):
    """y = x W^T + b + (alpha/rank) * (x (A - bound)) B, computed in `dtype`.

    A is stored uniform in [0, 2*bound), bound = sqrt(6/in) (kaiming-uniform
    like PEFT once shifted), B zeros, so training starts at the base model.
    rank=0 disables LoRA.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 lora_rank: int = 0, lora_alpha: float = 0.0,
                 lora_dropout: float = 0.0, lora_dtype=torch.float32,
                 kernel_dtype=None, int8_matmul=False):
        super().__init__()
        if lora_dropout > 0.0:
            raise NotImplementedError("LoRA dropout is not ported yet")
        if int8_matmul not in (False, True, "fwd", "fwd_bwd"):
            raise ValueError(f"int8_matmul must be false, true, 'fwd' or 'fwd_bwd', "
                             f"not {int8_matmul!r}")
        self.in_features = in_features
        self.features = features
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.int8_matmul = int8_matmul
        # kernel_dtype: the storage dtype of the base weight alone (e.g. fp8)
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               dtype=kernel_dtype or param_dtype))
        self.bias = (nn.Parameter(torch.empty(features, dtype=param_dtype))
                     if use_bias else None)
        if lora_rank > 0:
            self.lora_bound = math.sqrt(6.0 / in_features)
            self.lora_scaling = lora_alpha / lora_rank
            self.lora_a = nn.Parameter(torch.empty(in_features, lora_rank, dtype=lora_dtype))
            self.lora_b = nn.Parameter(torch.empty(lora_rank, features, dtype=lora_dtype))
        else:
            self.lora_a = self.lora_b = None
        # the int8 weight's per-output-channel scales, ones until
        # prequantize_int8_ writes the real ones
        self.kernel_scale = (nn.Parameter(torch.empty(features, dtype=torch.float32))
                             if int8_matmul else None)

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
        if self.kernel_scale is not None:
            self.kernel_scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        if self.int8_matmul:
            fwd_bwd = self.int8_matmul == "fwd_bwd"
            if self.weight.is_floating_point():
                y = (int8_dot_bwd8 if fwd_bwd else int8_dot)(h, self.weight)
            else:
                y = (int8_pq_dot_bwd8 if fwd_bwd else int8_pq_dot)(
                    h, self.weight, self.kernel_scale)
            if self.bias is not None:
                y = y + self.bias.to(self.dtype)
        else:
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


@torch.no_grad()
def prequantize_int8_(model: nn.Module) -> int:
    """In place, the JAX prequantize_int8_tree: every frozen LoraDense with
    a kernel_scale and a float weight gets the weight's int8 image (a frozen
    int8 parameter) and its real per-output-channel scales. One weight at a
    time, so the model never holds two copies of its weights. Trainable
    weights stay float (they need real gradients). Returns the count."""
    n = 0
    for m in model.modules():
        if (isinstance(m, LoraDense) and m.kernel_scale is not None
                and m.weight.is_floating_point() and not m.weight.requires_grad):
            w8, scale = quantize_kernel_int8(m.weight)
            m.weight = nn.Parameter(w8, requires_grad=False)
            m.kernel_scale.copy_(scale)
            n += 1
    return n


def block_kernel_kwargs(model_config) -> dict:
    """base_kernel_dtype and int8_matmul of a model config from `[model]`'s
    transformer_dtype (e.g. "float8": fp8 storage of the block weights) and
    int8_matmul, as the JAX pipelines read them."""
    td = model_config.get("transformer_dtype")
    return dict(base_kernel_dtype=dtype_from_string(td) if td else None,
                int8_matmul=model_config.get("int8_matmul", False))


REMAT_SPECS = ("full", "attn")


def remat_spec(config) -> str:
    """`activation_checkpointing` as a remat spec: "" (off), "full" (each
    block's forward is recomputed in the backward) or "attn" (the same, but
    the flash-attention forward's O and LSE are saved, so the backward never
    re-runs K1). The JAX package's "dots", "offload_attn", "unsloth" and
    "offload_dots" are not ported yet."""
    ac = config.get("activation_checkpointing", False)
    if not ac:
        return ""
    spec = str(config.get("remat_policy", "full")) if ac is True else str(ac)
    if spec not in REMAT_SPECS:
        raise NotImplementedError(
            f"activation_checkpointing {spec!r} is not ported yet; use true or 'attn'"
        )
    return spec


def _attn_context():
    """The "attn" policy, jax.checkpoint_policies.save_only_these_names(
    "flash_out"): the forward records each flash forward's O and LSE in a
    store of its own checkpoint call (so GAS's several forwards before one
    backward keep theirs apart), the recompute takes them back instead of
    launching K1, and the store goes with the call's backward."""
    store = deque()
    return fa.record_forwards(store), fa.replay_forwards(store)


def remat_call(spec: str, block, *args):
    """block(*args) under torch.utils.checkpoint with the remat spec's
    policy ("full" or "attn")."""
    if spec == "attn":
        return checkpoint(block, *args, use_reentrant=False, context_fn=_attn_context)
    return checkpoint(block, *args, use_reentrant=False)


def init_module_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Run init_weights on every submodule that has one, in module order."""
    for m in module.modules():
        fn = getattr(m, "init_weights", None)
        if fn is not None:
            fn(generator)
