"""Flux DiT (dev/schnell) as a PyTorch module.

Counterpart of diffusion_pipe_tpu/models/flux_model.py: separate txt/img
streams through the double (MMDiT) blocks, the joint [txt, img] sequence
through the single blocks, timestep and guidance embedded at x1000, joint
attention with multi-axis RoPE, the output cut to the image tokens. The
blocks live in nn.ModuleLists (the JAX package scans a stacked [L] axis;
interop.py splits it). With `remat` set, each block runs under
torch.utils.checkpoint, so its forward is recomputed in the backward:
attention kernel included under "full", the flash forward's saved O and
LSE under "attn". The timestep embedding goes raw to every block and to
the output norm, each of which applies SiLU once before its modulation
linear, as diffusers and BFL do (the JAX module applies it twice). The
block linears (14 a double block, 6 a single block) take
base_kernel_dtype (fp8 storage) and int8_matmul; the embedders, norms and
head keep param_dtype, as in the JAX package. Block swap, prefetch and
sequence sharding are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import (
    LoraDense,
    PixArtAlphaTextProjection,
    RMSNorm,
    TimestepEmbedder,
    apply_rope,
    layer_norm,
    modulate,
    remat_call,
    rope_frequencies,
)


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 19          # double (MMDiT) blocks
    num_single_layers: int = 38   # single-stream blocks
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096  # T5 features
    pooled_projection_dim: int = 768  # CLIP pooled
    guidance_embeds: bool = True      # dev: True, schnell: False
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    mlp_ratio: float = 4.0
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
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @staticmethod
    def tiny(**kw) -> "FluxConfig":
        """Small config for tests (same sizes as the JAX FluxConfig.tiny)."""
        defaults = dict(
            in_channels=64, out_channels=64, num_layers=2, num_single_layers=2,
            attention_head_dim=32, num_attention_heads=4, joint_attention_dim=64,
            pooled_projection_dim=32, axes_dims_rope=(8, 12, 12),
            dtype=torch.float32, param_dtype=torch.float32,
        )
        defaults.update(kw)
        return FluxConfig(**defaults)

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


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, heads, -1)


class FluxDoubleBlock(nn.Module):
    """MMDiT block: separate img/txt streams, joint attention."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        dim, hd, mlp = cfg.hidden_size, cfg.attention_head_dim, cfg.mlp_dim
        self.norm1_linear = cfg.dense(dim, 6 * dim)
        self.norm1_context_linear = cfg.dense(dim, 6 * dim)
        for prefix in ("attn_to", "attn_add"):
            for p in ("q", "k", "v"):
                setattr(self, f"{prefix}_{p}", cfg.dense(dim, dim))
        self.attn_norm_q = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.attn_norm_k = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.attn_norm_added_q = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.attn_norm_added_k = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.attn_to_out = cfg.dense(dim, dim)
        self.attn_to_add_out = cfg.dense(dim, dim)
        self.ff_in = cfg.dense(dim, mlp)
        self.ff_out = cfg.dense(mlp, dim)
        self.ff_context_in = cfg.dense(dim, mlp)
        self.ff_context_out = cfg.dense(mlp, dim)

    def forward(self, img, txt, temb, rope_cos, rope_sin, txt_mask=None):
        heads = self.cfg.num_attention_heads
        act = F.silu(temb)
        (i_shift_msa, i_scale_msa, i_gate_msa,
         i_shift_mlp, i_scale_mlp, i_gate_mlp) = self.norm1_linear(act).chunk(6, dim=-1)
        (t_shift_msa, t_scale_msa, t_gate_msa,
         t_shift_mlp, t_scale_mlp, t_gate_mlp) = self.norm1_context_linear(act).chunk(6, dim=-1)

        img_n = modulate(layer_norm(img), i_shift_msa, i_scale_msa)
        txt_n = modulate(layer_norm(txt), t_shift_msa, t_scale_msa)

        iq = self.attn_norm_q(_split_heads(self.attn_to_q(img_n), heads))
        ik = self.attn_norm_k(_split_heads(self.attn_to_k(img_n), heads))
        iv = _split_heads(self.attn_to_v(img_n), heads)
        tq = self.attn_norm_added_q(_split_heads(self.attn_add_q(txt_n), heads))
        tk = self.attn_norm_added_k(_split_heads(self.attn_add_k(txt_n), heads))
        tv = _split_heads(self.attn_add_v(txt_n), heads)

        # joint sequence: [txt, img] (diffusers order; rope ids match)
        q = apply_rope(torch.cat([tq, iq], dim=1), rope_cos, rope_sin)
        k = apply_rope(torch.cat([tk, ik], dim=1), rope_cos, rope_sin)
        v = torch.cat([tv, iv], dim=1)
        kv_mask = None
        if txt_mask is not None:
            img_valid = torch.ones(img.shape[:2], dtype=torch.int32, device=img.device)
            kv_mask = torch.cat([txt_mask.to(torch.int32), img_valid], dim=1)
        attn = dot_product_attention(q, k, v, kv_mask).flatten(2)
        txt_len = txt.shape[1]
        txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]

        img = img + i_gate_msa[:, None, :] * self.attn_to_out(img_attn)
        txt = txt + t_gate_msa[:, None, :] * self.attn_to_add_out(txt_attn)

        img_m = modulate(layer_norm(img), i_shift_mlp, i_scale_mlp)
        img_m = self.ff_out(F.gelu(self.ff_in(img_m), approximate="tanh"))
        img = img + i_gate_mlp[:, None, :] * img_m

        txt_m = modulate(layer_norm(txt), t_shift_mlp, t_scale_mlp)
        txt_m = self.ff_context_out(F.gelu(self.ff_context_in(txt_m), approximate="tanh"))
        txt = txt + t_gate_mlp[:, None, :] * txt_m
        return img, txt


class FluxSingleBlock(nn.Module):
    """Single-stream DiT block over the joint [txt, img] sequence."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        dim, hd, mlp = cfg.hidden_size, cfg.attention_head_dim, cfg.mlp_dim
        self.norm_linear = cfg.dense(dim, 3 * dim)
        self.attn_to_q = cfg.dense(dim, dim)
        self.attn_to_k = cfg.dense(dim, dim)
        self.attn_to_v = cfg.dense(dim, dim)
        self.attn_norm_q = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.attn_norm_k = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.proj_mlp = cfg.dense(dim, mlp)
        self.proj_out = cfg.dense(dim + mlp, dim)

    def forward(self, x, temb, rope_cos, rope_sin, kv_mask=None):
        heads = self.cfg.num_attention_heads
        shift, scale, gate = self.norm_linear(F.silu(temb)).chunk(3, dim=-1)
        x_n = modulate(layer_norm(x), shift, scale)
        q = self.attn_norm_q(_split_heads(self.attn_to_q(x_n), heads))
        k = self.attn_norm_k(_split_heads(self.attn_to_k(x_n), heads))
        v = _split_heads(self.attn_to_v(x_n), heads)
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
        attn = dot_product_attention(q, k, v, kv_mask).flatten(2)
        mlp = F.gelu(self.proj_mlp(x_n), approximate="tanh")
        out = self.proj_out(torch.cat([attn, mlp], dim=-1))
        return x + gate[:, None, :] * out


class FluxTransformer(nn.Module):
    """The full Flux DiT."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.x_embedder = LoraDense(cfg.in_channels, dim, **dd)
        self.context_embedder = LoraDense(cfg.joint_attention_dim, dim, **dd)
        self.timestep_embedder = TimestepEmbedder(dim, **dd)
        self.guidance_embedder = TimestepEmbedder(dim, **dd) if cfg.guidance_embeds else None
        self.text_embedder = PixArtAlphaTextProjection(cfg.pooled_projection_dim, dim, **dd)
        self.double_blocks = nn.ModuleList(
            [FluxDoubleBlock(cfg) for _ in range(cfg.num_layers)])
        self.single_blocks = nn.ModuleList(
            [FluxSingleBlock(cfg) for _ in range(cfg.num_single_layers)])
        self.norm_out_linear = LoraDense(dim, 2 * dim, **dd)
        self.proj_out = LoraDense(dim, cfg.out_channels, **dd)

    def time_text_embed(self, timestep, guidance, pooled):
        """timestep/guidance in [0, 1], embedded at x1000."""
        temb = self.timestep_embedder(timestep.float() * 1000.0)
        if self.guidance_embedder is not None and guidance is not None:
            temb = temb + self.guidance_embedder(guidance.float() * 1000.0)
        return temb + self.text_embedder(pooled.to(self.cfg.dtype))

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(
        self,
        hidden_states,          # [B, S_img, in_channels] packed 2x2 latents
        encoder_hidden_states,  # [B, S_txt, joint_attention_dim] T5 embeds
        pooled_projections,     # [B, pooled_projection_dim] CLIP pooled
        timestep,               # [B] in [0, 1]
        img_ids,                # [S_img, 3]
        txt_ids,                # [S_txt, 3]
        guidance=None,          # [B] or None
        txt_mask=None,          # [B, S_txt] optional text validity
        img_seq_len: Optional[int] = None,  # output length (Kontext truncation)
    ):
        cfg = self.cfg
        img = self.x_embedder(hidden_states)
        txt = self.context_embedder(encoder_hidden_states)
        # the raw sum of the embedders: each block and the output norm apply
        # SiLU once before their modulation linears (diffusers, BFL)
        temb = self.time_text_embed(timestep, guidance, pooled_projections)
        ids = torch.cat([txt_ids, img_ids], dim=0)
        rope_cos, rope_sin = rope_frequencies(ids, cfg.axes_dims_rope, cfg.rope_theta)

        for block in self.double_blocks:
            img, txt = self._run(block, img, txt, temb, rope_cos, rope_sin, txt_mask)

        x = torch.cat([txt, img], dim=1)
        kv_mask = None
        if txt_mask is not None:
            kv_mask = torch.cat(
                [txt_mask.to(torch.int32),
                 torch.ones(img.shape[:2], dtype=torch.int32, device=img.device)],
                dim=1)
        for block in self.single_blocks:
            x = self._run(block, x, temb, rope_cos, rope_sin, kv_mask)

        out = x[:, txt.shape[1]:]
        if img_seq_len is not None:
            out = out[:, :img_seq_len]
        # AdaLayerNormContinuous: diffusers chunk order is (scale, shift)
        scale, shift = self.norm_out_linear(F.silu(temb)).chunk(2, dim=-1)
        out = modulate(layer_norm(out), shift, scale)
        return self.proj_out(out)
