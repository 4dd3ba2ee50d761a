"""Shared building blocks: the adapter-aware linear (LoRA, LoKr, adapter
dropout), norms, embeddings, RoPE and the activation-checkpointing
policies.

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
- LoKr: lokr_w1 [in_m, out_m], lokr_w2 [in_n, out_n] or lokr_w2_a [in_n,
  rank] and lokr_w2_b [rank, out_n], the Flax layouts, the w2 factors
  stored unshifted like lora_a.
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

import contextlib
import functools
import math
import types
from collections import deque
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common import dtype_from_string, weak_scalar
from ..ops import flash_attention as fa
from ..ops.int8_quant import int_mm, quant_rows, rescale_i32
from ..ops.offload import HostQueue

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
    def residuals(x, w):
        return (w,)

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
    def residuals(x, w8, w_scale):
        return (w8, w_scale)

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


# --- the products of a linear, and what the "dots" policies keep of them -----


def _rows(g: torch.Tensor, x: torch.Tensor):
    return g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])


class _Dense(torch.autograd.Function):
    """x W^T + b for x [..., in], W [out, in] (F.linear), with its
    gradients written out as autograd computes F.linear's (dx = g W, dW =
    g^T x, db = the sum of g's rows), for the "dots" policies' kept
    products."""

    @staticmethod
    def residuals(x, w, b):
        return (x, w)

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        g2, x2 = _rows(g, x)
        dx = (g2 @ w).reshape(x.shape) if need_x else None
        dw = g2.t() @ x2 if need_w else None
        db = g2.sum(0) if need_b else None
        return dx, dw, db


class _Matmul(torch.autograd.Function):
    """x @ W for x [..., in], W [in, out] (the adapter factors' layout)."""

    @staticmethod
    def residuals(x, w):
        return (x, w)

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        g2, x2 = _rows(g, x)
        dx = (g2 @ w.t()).reshape(x.shape) if need_x else None
        dw = x2.t() @ g2 if need_w else None
        return dx, dw


_Dense.plain = staticmethod(F.linear)
_Matmul.plain = staticmethod(torch.matmul)
for _fn in (_Int8Dot, _Int8DotBwd8, _Int8PqDot, _Int8PqDotBwd8):
    _fn.plain = _fn.apply


class _Replayed(torch.autograd.Function):
    """A product's output kept from the forward, in the recompute of a
    "dots" block: no product runs, and it saves the residuals fn.forward
    saved (the checkpoint hands them to the forward's fn nodes; its own
    backward is fn's, for a graph built outside a checkpoint)."""

    @staticmethod
    def forward(ctx, fn, y, *inputs):
        ctx.fn = fn
        # the residuals the product's forward saves, in its order (the
        # checkpoint compares the recompute's saved tensors with those)
        ctx.save_for_backward(*fn.residuals(*inputs))
        return y

    @staticmethod
    def backward(ctx, g):
        view = types.SimpleNamespace(saved_tensors=ctx.saved_tensors,
                                     needs_input_grad=ctx.needs_input_grad[2:])
        return (None, None, *ctx.fn.backward(view, g))


# products run since reset_product_count(): twice a product a step under
# true or "attn" (forward and recompute), once under "dots" and "unsloth"
product_count = 0


def reset_product_count() -> None:
    global product_count
    product_count = 0


def product(fn, *inputs):
    """fn(*inputs) for a product Function (_Dense, _Matmul, the int8
    linears). In a checkpointed block under "dots", "unsloth" or
    "offload_dots", the forward runs fn.apply and keeps the output in the
    checkpoint call's store (on the card, or in pinned host memory), and
    the recompute takes it back instead of running the product again: the
    forward's graph then holds fn's nodes, whose backward reads the
    residuals _Replayed saves in the recompute. Elsewhere fn.plain runs,
    the same forward with autograd's own backward (the same products: a
    Function's Python cost, ~20 us a call, would add ~0.1 s a Wan step)."""
    global product_count
    mode, store = _remat_mode if _remat_mode is not None else (None, None)
    keep = store is not None and store.products is not None
    if keep and mode == "replay":
        return _Replayed.apply(fn, store.products.popleft(), *inputs)
    product_count += 1
    if not keep:
        return fn.plain(*inputs)
    y = fn.apply(*inputs)
    store.products.append(y.detach())
    return y


# --- adapter dropout ---------------------------------------------------------


class KeepMasks:
    """The keep masks of a training step's adapter dropout. Each draw is
    named by a token, an int64 drawn from a CPU generator seeded with
    `seed`; its mask is a uniform draw of a generator on the tensor's
    device seeded with the token, kept where it is below the keep rate. A
    recompute that has the token draws the same mask again."""

    def __init__(self, seed: int):
        self._gen = torch.Generator().manual_seed(int(seed))

    def token(self) -> int:
        return int(torch.randint(0, 2**62, (), generator=self._gen))

    def mask(self, token, shape, keep: float, device) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(token)
        return torch.rand(shape, generator=gen, device=device) < keep


class GivenMasks:
    """Keep masks handed in (bool tensors), in the order the forward asks
    for them: a LoKr linear's rank mask before its input mask, the linears
    in the order they run. The tests feed the JAX package's masks so."""

    def __init__(self, masks):
        self.masks = list(masks)
        self._next = 0

    def token(self) -> int:
        self._next += 1
        return self._next - 1

    def mask(self, token, shape, keep: float, device) -> torch.Tensor:
        m = self.masks[token]
        if tuple(m.shape) != tuple(shape):
            raise ValueError(f"keep mask {token} has shape {tuple(m.shape)}, "
                             f"the dropout needs {tuple(shape)}")
        return m.to(device=device, dtype=torch.bool)


_dropout_source = None


@contextlib.contextmanager
def adapter_dropout(source):
    """Within: the adapters' dropout (LoRA `dropout`, LoKr `rank_dropout`)
    draws its keep masks from `source` (KeepMasks or GivenMasks). Outside
    (evaluation, sampling) the adapters run without dropout, as the JAX
    LoraDense with deterministic = True."""
    global _dropout_source
    outer, _dropout_source = _dropout_source, source
    try:
        yield
    finally:
        _dropout_source = outer


def _keep_mask(shape, rate: float, device) -> Optional[torch.Tensor]:
    """The keep mask of one dropout, or None when no source is active. In a
    checkpointed block the forward records (source, token) in the
    checkpoint call's store and the recompute draws the same mask from it:
    torch.utils.checkpoint replays the default generators' state only."""
    mode, store = _remat_mode if _remat_mode is not None else (None, None)
    if mode == "replay":
        entry = store.masks.popleft()
    else:
        src = _dropout_source
        entry = None if src is None else (src, src.token())
        if store is not None:
            store.masks.append(entry)
    if entry is None:
        return None
    src, token = entry
    return src.mask(token, shape, 1.0 - rate, device)


def _dropout(h: torch.Tensor, rate: float) -> torch.Tensor:
    """flax nn.Dropout: where(keep, h / (1 - rate), 0)."""
    keep = _keep_mask(h.shape, rate, h.device)
    if keep is None:
        return h
    return torch.where(keep, h / weak_scalar(1.0 - rate, h), torch.zeros((), dtype=h.dtype,
                                                                      device=h.device))


def lokr_factorization(dim: int, factor: int = -1) -> Tuple[int, int]:
    """Balanced two-factor split (m, n) of dim, m <= n, m * n == dim
    (LyCORIS semantics, as the JAX package's): with factor > 0 dividing dim,
    (factor, dim // factor) ordered; otherwise the most square divisor pair
    with m <= factor (unbounded for factor < 0)."""
    if factor > 0 and dim % factor == 0:
        m, n = factor, dim // factor
        return (m, n) if m <= n else (n, m)
    cap = dim if factor < 0 else factor
    m, n = 1, dim
    cand = 1
    while cand * cand <= dim:
        if dim % cand == 0 and cand <= cap:
            m, n = cand, dim // cand
        cand += 1
    return m, n


class LoraDense(nn.Module):
    """y = x W^T + b + delta(x), computed in `dtype`.

    LoRA (lora_type "lora"): delta = (alpha/rank) * (drop(x) (A - bound)) B.
    A is stored uniform in [0, 2*bound), bound = sqrt(6/in)
    (kaiming-uniform like PEFT once shifted), B zeros, so training starts at
    the base model. rank=0 disables the adapter.

    LoKr (lora_type "lokr", LyCORIS / PEFT LoKrConfig): the weight delta is
    kron(w1, w2) with in = in_m * in_n and out = out_m * out_n
    (lokr_factorization with lokr_factor); w1 [in_m, out_m] starts at zero;
    w2 [in_n, out_n] is w2_a [in_n, rank] @ w2_b [rank, out_n] when rank <
    max(in_n, out_n), each stored uniform and shifted like A, scaled by
    alpha/rank, with rank dropout on w2_a's columns; else a full w2, scale
    1. The Kronecker product is never built: x as [..., in_m, in_n] times
    w2, then times w1, two products in that order.

    Dropout (LoRA `dropout` on the adapter's input, LoKr `rank_dropout`)
    draws its masks only inside adapter_dropout(); every product goes
    through product(), which the "dots" policies keep.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 lora_rank: int = 0, lora_alpha: float = 0.0,
                 lora_dropout: float = 0.0, lora_dtype=torch.float32,
                 kernel_dtype=None, int8_matmul=False, lora_type: str = "lora",
                 lokr_factor: int = -1, lokr_rank_dropout: float = 0.0):
        super().__init__()
        if int8_matmul not in (False, True, "fwd", "fwd_bwd"):
            raise ValueError(f"int8_matmul must be false, true, 'fwd' or 'fwd_bwd', "
                             f"not {int8_matmul!r}")
        if lora_type not in ("lora", "lokr"):
            raise ValueError(f"adapter type {lora_type!r}: expected 'lora' or 'lokr'")
        self.in_features = in_features
        self.features = features
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.lora_type = lora_type
        self.lora_dropout = lora_dropout
        self.int8_matmul = int8_matmul
        # kernel_dtype: the storage dtype of the base weight alone (e.g. fp8)
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               dtype=kernel_dtype or param_dtype))
        self.bias = (nn.Parameter(torch.empty(features, dtype=param_dtype))
                     if use_bias else None)
        self.lora_a = self.lora_b = None
        if lora_rank > 0 and lora_type == "lora":
            self.lora_bound = math.sqrt(6.0 / in_features)
            self.lora_scaling = lora_alpha / lora_rank
            self.lora_a = nn.Parameter(torch.empty(in_features, lora_rank, dtype=lora_dtype))
            self.lora_b = nn.Parameter(torch.empty(lora_rank, features, dtype=lora_dtype))
        elif lora_rank > 0:
            self._init_lokr(lora_alpha, lora_dtype, lokr_factor, lokr_rank_dropout)
        # the int8 weight's per-output-channel scales, ones until
        # prequantize_int8_ writes the real ones
        self.kernel_scale = (nn.Parameter(torch.empty(features, dtype=torch.float32))
                             if int8_matmul else None)

    def _init_lokr(self, alpha, lora_dtype, factor, rank_dropout):
        r = self.lora_rank
        self.lokr_in = lokr_factorization(self.in_features, factor)
        self.lokr_out = lokr_factorization(self.features, factor)
        (in_m, in_n), (out_m, out_n) = self.lokr_in, self.lokr_out
        self.lokr_rank_dropout = rank_dropout
        self.lokr_factored = r < max(in_n, out_n)
        self.lokr_w1 = nn.Parameter(torch.empty(in_m, out_m, dtype=lora_dtype))
        if self.lokr_factored:
            self.lokr_bounds = (math.sqrt(6.0 / in_n), math.sqrt(6.0 / r))
            self.lokr_scaling = alpha / r
            self.lokr_w2_a = nn.Parameter(torch.empty(in_n, r, dtype=lora_dtype))
            self.lokr_w2_b = nn.Parameter(torch.empty(r, out_n, dtype=lora_dtype))
        else:
            self.lokr_bounds = (math.sqrt(6.0 / in_n),)
            self.lokr_scaling = 1.0
            self.lokr_w2 = nn.Parameter(torch.empty(in_n, out_n, dtype=lora_dtype))

    @staticmethod
    def _uniform_(p, high, generator):
        tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        tmp.uniform_(0.0, high, generator=generator)
        p.copy_(tmp)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            self.bias.zero_()
        if self.lora_a is not None:
            self._uniform_(self.lora_a, 2 * self.lora_bound, generator)
            self.lora_b.zero_()
        if self.lora_rank > 0 and self.lora_type == "lokr":
            self.lokr_w1.zero_()
            if self.lokr_factored:
                self._uniform_(self.lokr_w2_a, 2 * self.lokr_bounds[0], generator)
                self._uniform_(self.lokr_w2_b, 2 * self.lokr_bounds[1], generator)
            else:
                self._uniform_(self.lokr_w2, 2 * self.lokr_bounds[0], generator)
        if self.kernel_scale is not None:
            self.kernel_scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        if self.int8_matmul:
            fwd_bwd = self.int8_matmul == "fwd_bwd"
            if self.weight.is_floating_point():
                y = product(_Int8DotBwd8 if fwd_bwd else _Int8Dot, h, self.weight)
            else:
                y = product(_Int8PqDotBwd8 if fwd_bwd else _Int8PqDot,
                            h, self.weight, self.kernel_scale)
            if self.bias is not None:
                y = y + self.bias.to(self.dtype)
        else:
            bias = None if self.bias is None else self.bias.to(self.dtype)
            y = product(_Dense, h, self.weight.to(self.dtype), bias)
        if self.lora_a is not None:
            if self.lora_dropout > 0.0:
                h = _dropout(h, self.lora_dropout)
            a = (self.lora_a - self.lora_bound).to(self.dtype)
            u = product(_Matmul, h, a)
            y = y + self.lora_scaling * product(_Matmul, u, self.lora_b.to(self.dtype))
        elif self.lora_rank > 0:
            y = y + self._lokr_delta(h)
        return y

    def _lokr_delta(self, h: torch.Tensor) -> torch.Tensor:
        (in_m, in_n), (out_m, out_n) = self.lokr_in, self.lokr_out
        if self.lokr_factored:
            bound_a, bound_b = self.lokr_bounds
            w2_a = self.lokr_w2_a - bound_a
            w2_b = self.lokr_w2_b - bound_b
            if self.lokr_rank_dropout > 0.0:
                keep = _keep_mask((self.lora_rank,), self.lokr_rank_dropout, w2_a.device)
                if keep is not None:
                    w2_a = w2_a * (keep.to(w2_a.dtype)
                                   / weak_scalar(1.0 - self.lokr_rank_dropout, w2_a))
            w2 = product(_Matmul, w2_a.to(self.dtype), w2_b.to(self.dtype))
        else:
            w2 = (self.lokr_w2 - self.lokr_bounds[0]).to(self.dtype)
        if self.lora_dropout > 0.0:
            h = _dropout(h, self.lora_dropout)
        lead = h.shape[:-1]
        n = h[..., 0].numel()
        t = product(_Matmul, h.reshape(n * in_m, in_n), w2)           # [n in_m, out_n]
        t = t.reshape(n, in_m, out_n).transpose(1, 2).reshape(n * out_n, in_m)
        d = product(_Matmul, t, self.lokr_w1.to(self.dtype))          # [n out_n, out_m]
        d = d.reshape(n, out_n, out_m).transpose(1, 2).reshape(*lead, self.features)
        return self.lokr_scaling * d


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


def adapter_kwargs(config, model_dtype: str) -> dict:
    """The block linears' adapter kwargs from `[adapter]` (LoRA or LoKr:
    rank, alpha, dropout, decompose_factor, rank_dropout, dtype), as the
    JAX pipelines read them; {} without an adapter."""
    adapter = config.get("adapter", {})
    if not adapter:
        return {}
    if adapter.get("type") not in ("lora", "lokr"):
        raise NotImplementedError(f"adapter type {adapter.get('type')!r} is not implemented")
    return dict(
        lora_rank=int(adapter["rank"]),
        lora_type=adapter["type"],
        lokr_factor=int(adapter.get("decompose_factor", -1)),
        lokr_rank_dropout=float(adapter.get("rank_dropout", 0.0)),
        lora_alpha=float(adapter["alpha"]),
        lora_dropout=float(adapter.get("dropout", 0.0)),
        lora_dtype=dtype_from_string(adapter.get("dtype", model_dtype)),
    )


REMAT_SPECS = ("full", "attn", "dots", "offload_attn", "unsloth", "offload_dots")
# what each policy keeps from a checkpointed block's forward for its
# recompute: the flash forwards' (O, LSE), every product's output, and
# whether those wait in pinned host memory
_KEEPS = {
    "full": (False, False, False),
    "attn": (True, False, False),
    "dots": (False, True, False),
    "offload_attn": (True, False, True),
    "unsloth": (False, True, True),
    "offload_dots": (False, True, True),
}


def remat_spec(config) -> str:
    """`activation_checkpointing` as a remat spec: "" (off), or the policy
    under which each block's forward is recomputed in the backward:
    - "full" (true): nothing kept, everything recomputed;
    - "attn": the flash forwards' O and LSE kept, so K1 never runs again;
    - "dots": every product's output kept (the JAX package's
      dots_with_no_batch_dims_saveable), so the recompute runs no GEMM;
    - "offload_attn": "attn" with O and LSE in pinned host memory;
    - "unsloth" / "offload_dots": "dots" with the outputs in pinned host
      memory.
    `activation_checkpointing = true` reads `remat_policy` (default full)."""
    ac = config.get("activation_checkpointing", False)
    if not ac:
        return ""
    spec = str(config.get("remat_policy", "full")) if ac is True else str(ac)
    if spec not in REMAT_SPECS:
        raise ValueError(f"unknown activation_checkpointing / remat_policy {spec!r}; "
                         f"expected true or one of {REMAT_SPECS[1:]}")
    return spec


class RematStore:
    """What one checkpoint call keeps between its forward and its
    recompute, each a FIFO in the order the forward made it: the dropout
    masks' (source, token) always; the flash forwards' (O, LSE) under the
    "attn" policies; the products' outputs under the "dots" ones. Each
    checkpoint call has its own, so the several forwards of gradient
    accumulation keep theirs apart; it goes with the call's backward."""

    def __init__(self, spec: str):
        flash, products, offload = _KEEPS[spec]
        queue = HostQueue if offload else deque
        self.masks = deque()
        self.flash = queue() if flash else None
        self.products = queue() if products else None


# (mode, store) while a checkpointed block runs: "record" in its forward,
# "replay" in its recompute. A plain global, as flash_attention's: the
# recompute runs on autograd's device thread.
_remat_mode = None


@contextlib.contextmanager
def _store_mode(mode: str, store: RematStore):
    global _remat_mode
    outer, _remat_mode = _remat_mode, (mode, store)
    try:
        if store.flash is None:
            yield
        else:
            keep = fa.record_forwards if mode == "record" else fa.replay_forwards
            with keep(store.flash):
                yield
    finally:
        _remat_mode = outer


def _remat_context(spec: str):
    store = RematStore(spec)
    return _store_mode("record", store), _store_mode("replay", store)


def remat_call(spec: str, block, *args):
    """block(*args) under torch.utils.checkpoint with the remat spec's
    policy, through a per-call RematStore behind context_fn (not torch's
    dispatch-mode selective checkpointing, whose per-op hooks cost the host
    0.4-0.8 s a Flux step)."""
    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=functools.partial(_remat_context, spec))


def init_module_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Run init_weights on every submodule that has one, in module order."""
    for m in module.modules():
        fn = getattr(m, "init_weights", None)
        if fn is not None:
            fn(generator)
