"""Wan 2.1 / 2.2 DiT as a PyTorch module.

Counterpart of diffusion_pipe_tpu/models/wan_model.py: a Conv3d patch
embedding (kernel = stride = (1, 2, 2)), the f32 time embedding and its
6-way projection, the text-embedding MLP, blocks of 3-axis-RoPE
self-attention, text cross-attention and a tanh-GELU FFN, each modulated by
its learnable [1, 6, dim] table plus the time projection, and the modulated
head with unpatchify. model_type selects the variant: t2v; i2v and flf2v
(Wan2.1 image-to-video: in_dim 36, the CLIP-vision context through the
img_emb MLP prepended to the text, and in every block a second
cross-attention over the 257 (flf2v: 514) image tokens with its own
cross_attn_k_img / v_img / norm_k_img, summed before cross_attn_o); i2v_v2
(Wan2.2 A14B: in_dim 36, no CLIP branch); ti2v (Wan2.2 5B: 48 latent
channels in and out). The blocks live in an nn.ModuleList (the JAX package
scans a stacked [L] axis; interop.py splits it), and every per-block
parameter keeps the shape of the JAX per-block slice. With `remat` set, each
block runs under torch.utils.checkpoint, so its forward is recomputed in
the backward: attention kernels included under "full", the flash forwards'
saved O and LSE under "attn". The block linears take base_kernel_dtype (fp8
storage) and int8_matmul; the embeddings and the head keep their dtypes, as
in the JAX package.

Not ported: block swap and prefetch, and sequence sharding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import (
    LoraDense,
    PatchEmbed3d,
    RMSNorm,
    apply_rope,
    layer_norm,
    remat_call,
    rope_frequencies,
    sinusoidal_timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class WanConfig:
    """The JAX WanConfig's fields but for block swap and sequence sharding
    (qk_norm and cross_attn_norm on, as in every Wan variant)."""

    model_type: str = "t2v"  # t2v | i2v | flf2v | i2v_v2 | ti2v
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    lora_rank: int = 0
    lora_alpha: float = 0.0
    lora_dropout: float = 0.0
    lora_dtype: torch.dtype = torch.float32
    # "lora" or "lokr" (with the LoKr decompose_factor and rank_dropout)
    lora_type: str = "lora"
    lokr_factor: int = -1
    lokr_rank_dropout: float = 0.0
    remat: str = ""
    # the block linears' base weights: storage dtype (None: param_dtype; the
    # JAX package's transformer_dtype, e.g. float8) and W8A8 int8 compute
    base_kernel_dtype: Optional[torch.dtype] = None
    int8_matmul: Any = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def uses_clip(self) -> bool:
        """The Wan2.1 i2v / flf2v image branch (img_emb, k_img / v_img)."""
        return self.model_type in ("i2v", "flf2v")

    @property
    def clip_tokens(self) -> int:
        """Image-context tokens: 257 CLIP tokens a frame, two frames for flf2v."""
        return 257 * (2 if self.model_type == "flf2v" else 1)

    @property
    def rope_axes_dim(self) -> Tuple[int, int, int]:
        """Per-axis rotary dims (t, h, w): with c = head_dim // 2 complex
        pairs, (c - 2*(c//3), c//3, c//3) pairs; (44, 42, 42) at 128."""
        c = self.head_dim // 2
        return (2 * (c - 2 * (c // 3)), 2 * (c // 3), 2 * (c // 3))

    @staticmethod
    def tiny(**kw) -> "WanConfig":
        """Small config for tests (same sizes as the JAX WanConfig.tiny)."""
        d = dict(dim=64, ffn_dim=128, num_heads=4, num_layers=2, freq_dim=32,
                 text_dim=32, text_len=16, dtype=torch.float32,
                 param_dtype=torch.float32)
        d.update(kw)
        return WanConfig(**d)

    def dense(self, in_features: int, features: int) -> LoraDense:
        """A block linear: the adapter (LoRA or LoKr) on, in the model's dtypes, its base weight
        stored in base_kernel_dtype and multiplied in int8 under int8_matmul."""
        return LoraDense(in_features, features, dtype=self.dtype,
                         param_dtype=self.param_dtype, lora_rank=self.lora_rank,
                         lora_alpha=self.lora_alpha, lora_dropout=self.lora_dropout,
                         lora_dtype=self.lora_dtype, kernel_dtype=self.base_kernel_dtype,
                         int8_matmul=self.int8_matmul, lora_type=self.lora_type,
                         lokr_factor=self.lokr_factor,
                         lokr_rank_dropout=self.lokr_rank_dropout)


def _modulation_init_(w: torch.Tensor, dim: int, generator: torch.Generator) -> None:
    """normal / sqrt(dim), drawn in f32 and cast (the JAX package's init)."""
    tmp = torch.randn(w.shape, generator=generator, dtype=torch.float32, device=w.device)
    w.copy_(tmp / dim ** 0.5)


class WanAttentionBlock(nn.Module):
    """Self-attention with 3-axis RoPE, text cross-attention, FFN."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.dim
        self.modulation = nn.Parameter(torch.empty(1, 6, dim, dtype=cfg.param_dtype))
        linears = ["self_attn_q", "self_attn_k", "self_attn_v", "self_attn_o",
                   "cross_attn_q", "cross_attn_k", "cross_attn_v", "cross_attn_o"]
        norms = ["self_attn_norm_q", "self_attn_norm_k", "cross_attn_norm_q", "cross_attn_norm_k"]
        if cfg.uses_clip:
            linears += ["cross_attn_k_img", "cross_attn_v_img"]
            norms += ["cross_attn_norm_k_img"]
        for name in linears:
            setattr(self, name, cfg.dense(dim, dim))
        # q/k RMSNorm over the full model dim, before the head split
        for name in norms:
            setattr(self, name, RMSNorm(dim, eps=cfg.eps, param_dtype=cfg.param_dtype))
        self.norm3_scale = nn.Parameter(torch.empty(dim, dtype=cfg.param_dtype))
        self.norm3_bias = nn.Parameter(torch.empty(dim, dtype=cfg.param_dtype))
        self.ffn_in = cfg.dense(dim, cfg.ffn_dim)
        self.ffn_out = cfg.dense(cfg.ffn_dim, dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        _modulation_init_(self.modulation, self.cfg.dim, generator)
        self.norm3_scale.fill_(1.0)
        self.norm3_bias.zero_()

    def forward(self, x, e0, rope_cos, rope_sin, context):
        """x [B, L, dim]; e0 [B, 1, 6, dim] f32; context [B, Lc, dim]."""
        cfg = self.cfg
        b, s, dim = x.shape
        heads, hd = cfg.num_heads, cfg.head_dim
        e = self.modulation.float()[None] + e0.float()
        e1, e2, e3, e4, e5, e6 = e.unbind(2)  # each [B, 1, dim]

        # self attention
        x_mod = (layer_norm(x, cfg.eps).float() * (1 + e2) + e1).to(cfg.dtype)
        q = self.self_attn_norm_q(self.self_attn_q(x_mod)).reshape(b, s, heads, hd)
        k = self.self_attn_norm_k(self.self_attn_k(x_mod)).reshape(b, s, heads, hd)
        v = self.self_attn_v(x_mod).reshape(b, s, heads, hd)
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
        y = self.self_attn_o(dot_product_attention(q, k, v).reshape(b, s, dim))
        x = x + (y.float() * e3).to(x.dtype)

        # text cross attention (+ the image branch of i2v / flf2v)
        x_c = layer_norm(x, cfg.eps, self.norm3_scale, self.norm3_bias)
        qc = self.cross_attn_norm_q(self.cross_attn_q(x_c)).reshape(b, s, heads, hd)
        if cfg.uses_clip:
            ctx_img, context = context[:, :cfg.clip_tokens], context[:, cfg.clip_tokens:]
        lc = context.shape[1]
        kc = self.cross_attn_norm_k(self.cross_attn_k(context)).reshape(b, lc, heads, hd)
        vc = self.cross_attn_v(context).reshape(b, lc, heads, hd)
        y = dot_product_attention(qc, kc, vc).reshape(b, s, dim)
        if cfg.uses_clip:
            li = ctx_img.shape[1]
            ki = self.cross_attn_norm_k_img(self.cross_attn_k_img(ctx_img))
            ki = ki.reshape(b, li, heads, hd)
            vi = self.cross_attn_v_img(ctx_img).reshape(b, li, heads, hd)
            y = y + dot_product_attention(qc, ki, vi).reshape(b, s, dim)
        x = x + self.cross_attn_o(y)

        # ffn
        x_mod = (layer_norm(x, cfg.eps).float() * (1 + e5) + e4).to(cfg.dtype)
        y = self.ffn_out(F.gelu(self.ffn_in(x_mod), approximate="tanh"))
        return x + (y.float() * e6).to(x.dtype)


class WanTransformer(nn.Module):
    """The full Wan DiT over one dense [B, C, F, H, W] bucket."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.dim
        dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        f32 = dict(dtype=torch.float32, param_dtype=cfg.param_dtype)
        self.patch_embedding = PatchEmbed3d(cfg.in_dim, dim, cfg.patch_size, **dd)
        self.time_embedding_1 = LoraDense(cfg.freq_dim, dim, **f32)
        self.time_embedding_2 = LoraDense(dim, dim, **f32)
        self.time_projection = LoraDense(dim, 6 * dim, **f32)
        self.text_embedding_1 = LoraDense(cfg.text_dim, dim, **dd)
        self.text_embedding_2 = LoraDense(dim, dim, **dd)
        if cfg.uses_clip:  # img_emb: LayerNorm, Linear, GELU, Linear, LayerNorm
            pd = cfg.param_dtype
            self.img_emb_norm1_scale = nn.Parameter(torch.empty(1280, dtype=pd))
            self.img_emb_norm1_bias = nn.Parameter(torch.empty(1280, dtype=pd))
            self.img_emb_1 = LoraDense(1280, 1280, **dd)
            self.img_emb_2 = LoraDense(1280, dim, **dd)
            self.img_emb_norm2_scale = nn.Parameter(torch.empty(dim, dtype=pd))
            self.img_emb_norm2_bias = nn.Parameter(torch.empty(dim, dtype=pd))
        self.blocks = nn.ModuleList([WanAttentionBlock(cfg) for _ in range(cfg.num_layers)])
        self.head_modulation = nn.Parameter(torch.empty(1, 2, dim, dtype=cfg.param_dtype))
        self.head = LoraDense(dim, math.prod(cfg.patch_size) * cfg.out_dim, **f32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        _modulation_init_(self.head_modulation, self.cfg.dim, generator)
        if self.cfg.uses_clip:
            for name in ("img_emb_norm1", "img_emb_norm2"):
                getattr(self, f"{name}_scale").fill_(1.0)
                getattr(self, f"{name}_bias").zero_()

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(self, x, t, context, clip_fea=None):
        """x [B, C, F, H, W] latents (i2v: with the mask and y channels); t
        [B] in [0, 1000]; context [B, text_len, text_dim] zero-padded text
        embeddings; clip_fea [B, 257 (flf2v 514), 1280] for i2v / flf2v."""
        cfg = self.cfg
        b, _, f, h, w = x.shape
        pt, ph, pw = cfg.patch_size
        gf, gh, gw = f // pt, h // ph, w // pw
        xe = self.patch_embedding(x)  # [B, L, dim]

        # time embedding in f32
        e = self.time_embedding_2(F.silu(self.time_embedding_1(
            sinusoidal_timestep_embedding(t, cfg.freq_dim))))  # [B, dim]
        e0 = self.time_projection(F.silu(e)).reshape(b, 1, 6, cfg.dim)

        ctx = self.text_embedding_1(context.to(cfg.dtype))
        ctx = self.text_embedding_2(F.gelu(ctx, approximate="tanh"))
        if cfg.uses_clip:
            ci = layer_norm(clip_fea.to(cfg.dtype), 1e-5, self.img_emb_norm1_scale,
                            self.img_emb_norm1_bias)
            ci = self.img_emb_2(F.gelu(self.img_emb_1(ci), approximate="tanh"))
            ci = layer_norm(ci, 1e-5, self.img_emb_norm2_scale, self.img_emb_norm2_bias)
            ctx = torch.cat([ci, ctx], dim=1)

        # 3-axis rope ids over the (gf, gh, gw) grid
        dev = xe.device
        ids = torch.stack([
            torch.arange(gf, device=dev).repeat_interleave(gh * gw),
            torch.arange(gh, device=dev).repeat_interleave(gw).repeat(gf),
            torch.arange(gw, device=dev).repeat(gf * gh),
        ], dim=-1)
        rope_cos, rope_sin = rope_frequencies(ids, cfg.rope_axes_dim)

        for block in self.blocks:
            xe = self._run(block, xe, e0, rope_cos, rope_sin, ctx)

        he = self.head_modulation.float()[None] + e[:, None, None, :]  # [B, 1, 2, dim]
        xf = layer_norm(xe, cfg.eps).float() * (1 + he[:, :, 1]) + he[:, :, 0]
        out = self.head(xf)  # f32 [B, L, pt*ph*pw*out_dim]

        # unpatchify -> [B, out_dim, F, H, W]
        out = out.reshape(b, gf, gh, gw, pt, ph, pw, cfg.out_dim)
        out = out.permute(0, 7, 1, 4, 2, 5, 3, 6)
        return out.reshape(b, cfg.out_dim, gf * pt, gh * ph, gw * pw)
