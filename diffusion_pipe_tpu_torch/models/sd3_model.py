"""SD3 / SD3.5 MMDiT (diffusers SD3Transformer2DModel) as a PyTorch module.

Counterpart of diffusion_pipe_tpu/models/sd3_model.py: joint text + image
dual-stream blocks like Flux's double blocks, with a cropped fixed 2-D
sincos position table in place of RoPE, optional q/k RMS norms (SD3.5),
and a context_pre_only final block whose text stream takes only (scale,
shift) and has no output path. Inputs: latents [B, C, H, W], t * 1000,
prompt embeddings [B, S, 4096] (CLIP rows then T5 rows) and the pooled
CLIP-L + CLIP-G vector [B, 2048].

The raw temb goes to every block and to the output norm, each of which
applies SiLU once before its modulation linear, as diffusers'
AdaLayerNormZero / AdaLayerNormContinuous do (the JAX module applies it
twice). The blocks live in an
nn.ModuleList `blocks` (the JAX package's scanned stack) plus
`final_block`; with `remat` set each of them runs under remat_call. The
block linears take the adapter, base_kernel_dtype (fp8 storage) and
int8_matmul; the embedders and head keep param_dtype. Attention goes to
ops/attention.dot_product_attention: K1-K3 at head dim 64 on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import (
    LoraDense,
    PixArtAlphaTextProjection,
    RMSNorm,
    TimestepEmbedder,
    layer_norm,
    modulate,
    remat_call,
)


@dataclasses.dataclass(frozen=True)
class SD3Config:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192
    sample_size: int = 128
    qk_norm: bool = False           # True for SD3.5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    base_kernel_dtype: Optional[torch.dtype] = None
    int8_matmul: Any = False
    lora_rank: int = 0
    lora_alpha: float = 0.0
    lora_dropout: float = 0.0
    lora_dtype: torch.dtype = torch.float32
    lora_type: str = "lora"
    lokr_factor: int = -1
    lokr_rank_dropout: float = 0.0
    remat: str = ""

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def num_scan_layers(self) -> int:
        """Blocks in `blocks` (the last joint block is `final_block`)."""
        return self.num_layers - 1

    @staticmethod
    def tiny(**kw) -> "SD3Config":
        """The JAX SD3Config.tiny sizes."""
        d = dict(num_layers=2, attention_head_dim=16, num_attention_heads=4,
                 joint_attention_dim=64, pooled_projection_dim=32, pos_embed_max_size=32,
                 sample_size=16, dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return SD3Config(**d)

    def dense(self, in_features: int, features: int) -> LoraDense:
        """A block linear: the adapter, base_kernel_dtype and int8_matmul."""
        return LoraDense(in_features, features, dtype=self.dtype, param_dtype=self.param_dtype,
                         lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                         lora_dropout=self.lora_dropout, lora_dtype=self.lora_dtype,
                         kernel_dtype=self.base_kernel_dtype, int8_matmul=self.int8_matmul,
                         lora_type=self.lora_type, lokr_factor=self.lokr_factor,
                         lokr_rank_dropout=self.lokr_rank_dropout)


def sincos_2d_pos_embed(embed_dim: int, grid_size: int, base_size: int) -> np.ndarray:
    """diffusers get_2d_sincos_pos_embed (interpolation_scale=1), in numpy
    float64 then f32: first half from the w index, second half from the h
    index, row-major (h, w). [grid * grid, D]."""
    pos = np.arange(grid_size, dtype=np.float64) / (grid_size / base_size)
    wg, hg = np.meshgrid(pos, pos)  # both [gh, gw], w varies along columns

    def embed_1d(dim, p):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", p.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([embed_1d(embed_dim // 2, wg), embed_1d(embed_dim // 2, hg)], axis=1)
    return emb.astype(np.float32)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, heads, -1)


class SD3JointBlock(nn.Module):
    def __init__(self, cfg: SD3Config, context_pre_only: bool = False):
        super().__init__()
        self.cfg = cfg
        self.context_pre_only = context_pre_only
        dim, hd = cfg.hidden_size, cfg.attention_head_dim
        self.norm1_linear = cfg.dense(dim, 6 * dim)
        self.norm1_context_linear = cfg.dense(dim, (2 if context_pre_only else 6) * dim)
        for prefix in ("attn_to", "attn_add"):
            for p in ("q", "k", "v"):
                setattr(self, f"{prefix}_{p}", cfg.dense(dim, dim))
            if cfg.qk_norm:
                setattr(self, f"{prefix}_norm_q", RMSNorm(hd, param_dtype=cfg.param_dtype))
                setattr(self, f"{prefix}_norm_k", RMSNorm(hd, param_dtype=cfg.param_dtype))
        self.attn_to_out = cfg.dense(dim, dim)
        self.ff_in = cfg.dense(dim, 4 * dim)
        self.ff_out = cfg.dense(4 * dim, dim)
        if not context_pre_only:
            self.attn_to_add_out = cfg.dense(dim, dim)
            self.ff_context_in = cfg.dense(dim, 4 * dim)
            self.ff_context_out = cfg.dense(4 * dim, dim)

    def _qkv(self, x, prefix):
        heads = self.cfg.num_attention_heads
        q = _heads(getattr(self, f"{prefix}_q")(x), heads)
        k = _heads(getattr(self, f"{prefix}_k")(x), heads)
        v = _heads(getattr(self, f"{prefix}_v")(x), heads)
        if self.cfg.qk_norm:
            q = getattr(self, f"{prefix}_norm_q")(q)
            k = getattr(self, f"{prefix}_norm_k")(k)
        return q, k, v

    def forward(self, img, txt, temb):
        act = F.silu(temb)
        (i_shift, i_scale, i_gate,
         i_shift_mlp, i_scale_mlp, i_gate_mlp) = self.norm1_linear(act).chunk(6, dim=-1)
        if self.context_pre_only:
            t_scale, t_shift = self.norm1_context_linear(act).chunk(2, dim=-1)
        else:
            (t_shift, t_scale, t_gate,
             t_shift_mlp, t_scale_mlp, t_gate_mlp) = self.norm1_context_linear(act).chunk(6, dim=-1)
        txt_n = modulate(layer_norm(txt), t_shift, t_scale)
        img_n = modulate(layer_norm(img), i_shift, i_scale)

        iq, ik, iv = self._qkv(img_n, "attn_to")
        tq, tk, tv = self._qkv(txt_n, "attn_add")
        attn = dot_product_attention(torch.cat([tq, iq], dim=1), torch.cat([tk, ik], dim=1),
                                     torch.cat([tv, iv], dim=1)).flatten(2)
        txt_len = txt.shape[1]
        txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]

        img = img + i_gate[:, None, :] * self.attn_to_out(img_attn)
        img_m = modulate(layer_norm(img), i_shift_mlp, i_scale_mlp)
        img_m = self.ff_out(F.gelu(self.ff_in(img_m), approximate="tanh"))
        img = img + i_gate_mlp[:, None, :] * img_m
        if self.context_pre_only:
            return img, txt

        txt = txt + t_gate[:, None, :] * self.attn_to_add_out(txt_attn)
        txt_m = modulate(layer_norm(txt), t_shift_mlp, t_scale_mlp)
        txt_m = self.ff_context_out(F.gelu(self.ff_context_in(txt_m), approximate="tanh"))
        txt = txt + t_gate_mlp[:, None, :] * txt_m
        return img, txt


class SD3Transformer(nn.Module):
    def __init__(self, cfg: SD3Config):
        super().__init__()
        self.cfg = cfg
        dim, p = cfg.hidden_size, cfg.patch_size
        dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.pos_embed_proj = LoraDense(p * p * cfg.in_channels, dim, **dd)
        self.timestep_embedder = TimestepEmbedder(dim, **dd)
        self.text_embedder = PixArtAlphaTextProjection(cfg.pooled_projection_dim, dim, **dd)
        self.context_embedder = LoraDense(cfg.joint_attention_dim, dim, **dd)
        self.blocks = nn.ModuleList([SD3JointBlock(cfg) for _ in range(cfg.num_scan_layers)])
        self.final_block = SD3JointBlock(cfg, context_pre_only=True)
        self.norm_out_linear = LoraDense(dim, 2 * dim, **dd)
        self.proj_out = LoraDense(dim, p * p * cfg.out_channels, **dd)
        self._pos_cache = {}

    def pos_embed(self, gh: int, gw: int, device) -> torch.Tensor:
        """The centred gh x gw crop of the fixed table, [1, gh * gw, D] f32
        (diffusers PatchEmbed.cropped_pos_embed)."""
        key = (gh, gw, str(device))
        if key not in self._pos_cache:
            cfg = self.cfg
            m, dim = cfg.pos_embed_max_size, cfg.hidden_size
            table = sincos_2d_pos_embed(dim, m, cfg.sample_size // cfg.patch_size)
            table = table.reshape(m, m, dim)
            top, left = (m - gh) // 2, (m - gw) // 2
            crop = table[top:top + gh, left:left + gw].reshape(1, gh * gw, dim)
            self._pos_cache[key] = torch.from_numpy(np.ascontiguousarray(crop)).to(device)
        return self._pos_cache[key]

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(self, hidden_states, timestep, encoder_hidden_states, pooled_projections):
        """hidden_states [B, C, H, W]; timestep [B] already x1000."""
        cfg = self.cfg
        p = cfg.patch_size
        b, c, h, w = hidden_states.shape
        gh, gw = h // p, w // p
        x = hidden_states.permute(0, 2, 3, 1).to(cfg.dtype)
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
        img = self.pos_embed_proj(x)
        img = img + self.pos_embed(gh, gw, img.device).to(img.dtype)

        temb = self.timestep_embedder(timestep.float())
        temb = temb + self.text_embedder(pooled_projections.to(cfg.dtype))
        txt = self.context_embedder(encoder_hidden_states.to(cfg.dtype))

        for block in self.blocks:
            img, txt = self._run(block, img, txt, temb)
        img, _ = self._run(self.final_block, img, txt, temb)

        scale, shift = self.norm_out_linear(F.silu(temb)).chunk(2, dim=-1)  # diffusers order
        img = modulate(layer_norm(img), shift, scale)
        out = self.proj_out(img).reshape(b, gh, gw, p, p, cfg.out_channels)
        return out.permute(0, 5, 1, 3, 2, 4).reshape(b, cfg.out_channels, h, w)
