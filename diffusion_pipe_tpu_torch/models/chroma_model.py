"""Chroma DiT (lodestones' flow `Chroma`) as a PyTorch module.

Counterpart of diffusion_pipe_tpu/models/chroma_model.py: the Flux-schnell
layout (19 double + 38 single blocks, head dim 128, multi-axis RoPE) with
no CLIP / pooled branch and no guidance embedder. Every adaLN modulation
vector comes from one "distilled guidance" Approximator MLP: for slot i of
mod_index_length (3 per single block, 12 per double block, 2 for the
final layer: 344 at full size) its input is the sinusoidal t (16),
guidance (16) and index (32) embeddings, then in_proj, n residual RMSNorm
-> Linear -> SiLU -> Linear layers and out_proj to the model width. Slot
layout: single blocks first, then double blocks, then the final layer.

T5 padding is a key mask: the text mask concatenated before ones for the
image tokens, in every block (K1-K3 take it on the card). The blocks live
in nn.ModuleLists `double_blocks` / `single_blocks`; with `remat` set each
runs under remat_call. Block linears take the adapter, base_kernel_dtype
and int8_matmul; the embedders, the Approximator and the head keep
param_dtype.
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
    RMSNorm,
    apply_rope,
    layer_norm,
    modulate,
    remat_call,
    rope_frequencies,
    sinusoidal_timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class ChromaConfig:
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    mlp_ratio: float = 4.0
    approximator_in_dim: int = 64
    approximator_hidden: int = 5120
    approximator_layers: int = 5
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
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def mod_index_length(self) -> int:
        return 3 * self.num_single_layers + 12 * self.num_layers + 2

    @staticmethod
    def tiny(**kw) -> "ChromaConfig":
        """The JAX ChromaConfig.tiny sizes."""
        d = dict(num_layers=2, num_single_layers=2, attention_head_dim=32,
                 num_attention_heads=4, joint_attention_dim=64, axes_dims_rope=(8, 12, 12),
                 approximator_hidden=64, approximator_layers=2, dtype=torch.float32,
                 param_dtype=torch.float32)
        d.update(kw)
        return ChromaConfig(**d)

    def dense(self, in_features: int, features: int) -> LoraDense:
        """A block linear: the adapter, base_kernel_dtype and int8_matmul."""
        return LoraDense(in_features, features, dtype=self.dtype, param_dtype=self.param_dtype,
                         lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                         lora_dropout=self.lora_dropout, lora_dtype=self.lora_dtype,
                         kernel_dtype=self.base_kernel_dtype, int8_matmul=self.int8_matmul,
                         lora_type=self.lora_type, lokr_factor=self.lokr_factor,
                         lokr_rank_dropout=self.lokr_rank_dropout)


class Approximator(nn.Module):
    """timestep, guidance [B] -> the modulation vectors [B, mod_index_length, D]."""

    def __init__(self, cfg: ChromaConfig):
        super().__init__()
        self.cfg = cfg
        dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        hidden = cfg.approximator_hidden
        self.in_proj = LoraDense(cfg.approximator_in_dim, hidden, **dd)
        for i in range(cfg.approximator_layers):
            setattr(self, f"norms_{i}", RMSNorm(hidden, param_dtype=cfg.param_dtype))
            setattr(self, f"layers_{i}_in", LoraDense(hidden, hidden, **dd))
            setattr(self, f"layers_{i}_out", LoraDense(hidden, hidden, **dd))
        self.out_proj = LoraDense(hidden, cfg.hidden_size, **dd)

    def forward(self, timestep, guidance):
        cfg = self.cfg
        n = cfg.mod_index_length
        b = timestep.shape[0]
        t_emb = sinusoidal_timestep_embedding(timestep.float() * 1000.0, 16)
        g_emb = sinusoidal_timestep_embedding(guidance.float() * 1000.0, 16)
        idx = sinusoidal_timestep_embedding(
            torch.arange(n, dtype=torch.float32, device=timestep.device), 32)
        tg = torch.cat([t_emb, g_emb], dim=-1)
        inp = torch.cat([tg[:, None].expand(b, n, 32), idx[None].expand(b, n, 32)], dim=-1)
        h = self.in_proj(inp.to(cfg.dtype))
        for i in range(cfg.approximator_layers):
            y = getattr(self, f"layers_{i}_in")(getattr(self, f"norms_{i}")(h))
            h = h + getattr(self, f"layers_{i}_out")(F.silu(y))
        return self.out_proj(h)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, heads, -1)


class ChromaDoubleBlock(nn.Module):
    def __init__(self, cfg: ChromaConfig):
        super().__init__()
        self.cfg = cfg
        dim, hd, mlp = cfg.hidden_size, cfg.attention_head_dim, cfg.mlp_dim
        for prefix in ("attn_to", "attn_add"):
            for p in ("q", "k", "v"):
                setattr(self, f"{prefix}_{p}", cfg.dense(dim, dim))
            setattr(self, f"{prefix}_norm_q", RMSNorm(hd, param_dtype=cfg.param_dtype))
            setattr(self, f"{prefix}_norm_k", RMSNorm(hd, param_dtype=cfg.param_dtype))
        self.attn_to_out = cfg.dense(dim, dim)
        self.ff_in = cfg.dense(dim, mlp)
        self.ff_out = cfg.dense(mlp, dim)
        self.attn_to_add_out = cfg.dense(dim, dim)
        self.ff_context_in = cfg.dense(dim, mlp)
        self.ff_context_out = cfg.dense(mlp, dim)

    def _qkv(self, x, prefix):
        heads = self.cfg.num_attention_heads
        q = getattr(self, f"{prefix}_norm_q")(_heads(getattr(self, f"{prefix}_q")(x), heads))
        k = getattr(self, f"{prefix}_norm_k")(_heads(getattr(self, f"{prefix}_k")(x), heads))
        return q, k, _heads(getattr(self, f"{prefix}_v")(x), heads)

    def forward(self, img, txt, mods, rope_cos, rope_sin, kv_mask=None):
        """mods [B, 12, D]: img (shift, scale, gate) x 2, then txt's."""
        (i_s1, i_c1, i_g1, i_s2, i_c2, i_g2,
         t_s1, t_c1, t_g1, t_s2, t_c2, t_g2) = mods.unbind(dim=1)
        iq, ik, iv = self._qkv(modulate(layer_norm(img), i_s1, i_c1), "attn_to")
        tq, tk, tv = self._qkv(modulate(layer_norm(txt), t_s1, t_c1), "attn_add")
        q = apply_rope(torch.cat([tq, iq], dim=1), rope_cos, rope_sin)
        k = apply_rope(torch.cat([tk, ik], dim=1), rope_cos, rope_sin)
        attn = dot_product_attention(q, k, torch.cat([tv, iv], dim=1), kv_mask).flatten(2)
        txt_len = txt.shape[1]
        txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]

        img = img + i_g1[:, None] * self.attn_to_out(img_attn)
        y = modulate(layer_norm(img), i_s2, i_c2)
        img = img + i_g2[:, None] * self.ff_out(F.gelu(self.ff_in(y), approximate="tanh"))

        txt = txt + t_g1[:, None] * self.attn_to_add_out(txt_attn)
        y = modulate(layer_norm(txt), t_s2, t_c2)
        txt = txt + t_g2[:, None] * self.ff_context_out(
            F.gelu(self.ff_context_in(y), approximate="tanh"))
        return img, txt


class ChromaSingleBlock(nn.Module):
    def __init__(self, cfg: ChromaConfig):
        super().__init__()
        self.cfg = cfg
        dim, hd, mlp = cfg.hidden_size, cfg.attention_head_dim, cfg.mlp_dim
        self.attn_to_q = cfg.dense(dim, dim)
        self.attn_to_k = cfg.dense(dim, dim)
        self.attn_to_v = cfg.dense(dim, dim)
        self.attn_norm_q = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.attn_norm_k = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.proj_mlp = cfg.dense(dim, mlp)
        self.proj_out = cfg.dense(dim + mlp, dim)

    def forward(self, x, mods, rope_cos, rope_sin, kv_mask=None):
        """mods [B, 3, D]: (shift, scale, gate)."""
        heads = self.cfg.num_attention_heads
        shift, scale, gate = mods.unbind(dim=1)
        x_n = modulate(layer_norm(x), shift, scale)
        q = apply_rope(self.attn_norm_q(_heads(self.attn_to_q(x_n), heads)), rope_cos, rope_sin)
        k = apply_rope(self.attn_norm_k(_heads(self.attn_to_k(x_n), heads)), rope_cos, rope_sin)
        v = _heads(self.attn_to_v(x_n), heads)
        attn = dot_product_attention(q, k, v, kv_mask).flatten(2)
        mlp = F.gelu(self.proj_mlp(x_n), approximate="tanh")
        return x + gate[:, None] * self.proj_out(torch.cat([attn, mlp], dim=-1))


class ChromaTransformer(nn.Module):
    def __init__(self, cfg: ChromaConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.x_embedder = LoraDense(cfg.in_channels, dim, **dd)
        self.context_embedder = LoraDense(cfg.joint_attention_dim, dim, **dd)
        self.distilled_guidance_layer = Approximator(cfg)
        self.double_blocks = nn.ModuleList([ChromaDoubleBlock(cfg) for _ in range(cfg.num_layers)])
        self.single_blocks = nn.ModuleList(
            [ChromaSingleBlock(cfg) for _ in range(cfg.num_single_layers)])
        self.proj_out = LoraDense(dim, cfg.out_channels, **dd)

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(
        self,
        hidden_states,          # [B, S_img, in_channels] packed 2x2 latents
        encoder_hidden_states,  # [B, S_txt, joint_attention_dim] T5 embeds
        timestep,               # [B] in [0, 1]
        img_ids,                # [S_img, 3]
        txt_ids,                # [S_txt, 3]
        guidance=None,          # [B] or None (zeros)
        txt_mask=None,          # [B, S_txt] nonzero = valid T5 token
        img_seq_len: Optional[int] = None,
    ):
        cfg = self.cfg
        dim = cfg.hidden_size
        b = hidden_states.shape[0]
        img = self.x_embedder(hidden_states.to(cfg.dtype))
        txt = self.context_embedder(encoder_hidden_states.to(cfg.dtype))
        if guidance is None:
            guidance = torch.zeros((b,), dtype=torch.float32, device=img.device)
        mods = self.distilled_guidance_layer(timestep, guidance)   # [B, n, D]
        ns, nd = cfg.num_single_layers, cfg.num_layers
        single_mods = mods[:, :3 * ns].reshape(b, ns, 3, dim)
        double_mods = mods[:, 3 * ns:3 * ns + 12 * nd].reshape(b, nd, 12, dim)
        shift, scale = mods[:, -2], mods[:, -1]

        rope_cos, rope_sin = rope_frequencies(torch.cat([txt_ids, img_ids], dim=0),
                                              cfg.axes_dims_rope, cfg.rope_theta)
        kv_mask = None
        if txt_mask is not None:
            kv_mask = torch.cat([txt_mask.to(torch.int32),
                                 torch.ones(img.shape[:2], dtype=torch.int32, device=img.device)],
                                dim=1)
        for i, block in enumerate(self.double_blocks):
            img, txt = self._run(block, img, txt, double_mods[:, i], rope_cos, rope_sin, kv_mask)
        x = torch.cat([txt, img], dim=1)
        for i, block in enumerate(self.single_blocks):
            x = self._run(block, x, single_mods[:, i], rope_cos, rope_sin, kv_mask)

        out = x[:, txt.shape[1]:]
        if img_seq_len is not None:
            out = out[:, :img_seq_len]
        return self.proj_out(modulate(layer_norm(out), shift, scale))
