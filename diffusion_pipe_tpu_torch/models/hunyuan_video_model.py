"""HunyuanVideo DiT (hyvideo HYVideoDiffusionTransformer) as a PyTorch module.

Counterpart of diffusion_pipe_tpu/models/hunyuan_video_model.py: 20 dual-
stream and 40 single-stream blocks at 3,072 wide (24 heads of 128), a
2-block token refiner on the LLaVA-Llama-3 text states, and the
conditioning vector of the timestep, CLIP-L's pooled output and the
distilled guidance. Joint attention runs over [image, text] with the key
mask [ones(image), text_mask] on K1-K3 at D 128; RoPE (interleaved pairs,
hyvideo's rotate_half) turns the image rows only. Attention q / k / v come
from one fused linear each stream (img_attn_qkv, txt_attn_qkv, linear1),
with per-head RMS q / k norms.

Each block takes the conditioning vector as the embedders give it and
applies SiLU once before its modulation linear, as hyvideo's ModulateDiT
does. The refiner and the embedders have no adapter (neither package adapts
them), and the refiner's input needs no gradient under an adapter: its two
attentions then run K1 alone. Under `remat` each double and single block
runs under torch.utils.checkpoint; the refiner does not (the JAX module
checkpoints its block stacks alone).

The head unflattens final_linear's rows as hyvideo's unpatchify does,
channels first: (c, pt, ph, pw). The JAX module reads them as (pt, ph, pw,
c); interop.hunyuan_video_state_dict reorders a JAX head's rows so both
compute the same function. Block swap and pipeline stages are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import (LoraDense, PatchEmbed3d, RMSNorm, apply_rope, layer_norm, modulate,
                     remat_call, rope_frequencies, sinusoidal_timestep_embedding)


@dataclasses.dataclass(frozen=True)
class HunyuanVideoConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_attention_heads: int = 24
    attention_head_dim: int = 128
    num_layers: int = 20          # double blocks
    num_single_layers: int = 40
    mlp_ratio: float = 4.0
    text_dim: int = 4096          # LLaVA-Llama-3 hidden
    pooled_projection_dim: int = 768  # CLIP-L
    rope_axes_dim: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 256.0
    guidance_embeds: bool = True
    refiner_layers: int = 2
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

    @staticmethod
    def tiny(**kw) -> "HunyuanVideoConfig":
        """The JAX HunyuanVideoConfig.tiny sizes."""
        d = dict(num_attention_heads=4, attention_head_dim=32, num_layers=2,
                 num_single_layers=2, text_dim=32, pooled_projection_dim=16,
                 rope_axes_dim=(8, 12, 12), refiner_layers=1,
                 dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return HunyuanVideoConfig(**d)


def block_dense(cfg, in_features: int, features: int, use_bias: bool = True) -> LoraDense:
    """A double or single block's linear: the adapter on, the base weight in
    base_kernel_dtype and multiplied in int8 under int8_matmul (any config
    with HunyuanVideoConfig's adapter fields)."""
    return LoraDense(in_features, features, use_bias, dtype=cfg.dtype,
                     param_dtype=cfg.param_dtype,
                     lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                     lora_dropout=cfg.lora_dropout, lora_dtype=cfg.lora_dtype,
                     kernel_dtype=cfg.base_kernel_dtype, int8_matmul=cfg.int8_matmul,
                     lora_type=cfg.lora_type, lokr_factor=cfg.lokr_factor,
                     lokr_rank_dropout=cfg.lokr_rank_dropout)


def plain_dense(cfg, in_features: int, features: int, dtype=None,
                use_bias: bool = True) -> LoraDense:
    """An embedder's, the refiner's or the head's linear: no adapter."""
    return LoraDense(in_features, features, use_bias, dtype=dtype or cfg.dtype,
                     param_dtype=cfg.param_dtype)


def _qkv(qkv: torch.Tensor, heads: int):
    b, s, _ = qkv.shape
    return qkv.reshape(b, s, 3, heads, -1).unbind(2)


class MLPEmbedder(nn.Module):
    """Linear -> SiLU -> Linear (hyvideo's TimestepEmbedder MLP, MLPEmbedder
    and TextProjection): `{name}_1` and `{name}_2` in the JAX module."""

    def __init__(self, cfg, in_features: int):
        super().__init__()
        dim = cfg.hidden_size
        self.linear_1 = plain_dense(cfg, in_features, dim)
        self.linear_2 = plain_dense(cfg, dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class TokenRefinerBlock(nn.Module):
    """hyvideo IndividualTokenRefinerBlock: affine LN, self-attention, affine
    LN, SiLU MLP, each gated per channel from c (timestep + masked mean of
    the text)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.adaLN_linear = plain_dense(cfg, dim, 2 * dim)
        self.norm1_scale = nn.Parameter(torch.empty(dim, dtype=cfg.param_dtype))
        self.norm1_bias = nn.Parameter(torch.empty(dim, dtype=cfg.param_dtype))
        self.self_attn_qkv = plain_dense(cfg, dim, 3 * dim)
        self.self_attn_proj = plain_dense(cfg, dim, dim)
        self.norm2_scale = nn.Parameter(torch.empty(dim, dtype=cfg.param_dtype))
        self.norm2_bias = nn.Parameter(torch.empty(dim, dtype=cfg.param_dtype))
        self.mlp_in = plain_dense(cfg, dim, cfg.mlp_dim)
        self.mlp_out = plain_dense(cfg, cfg.mlp_dim, dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for scale, bias in ((self.norm1_scale, self.norm1_bias),
                            (self.norm2_scale, self.norm2_bias)):
            scale.fill_(1.0)
            bias.zero_()

    def forward(self, x, c, txt_mask):
        gate_msa, gate_mlp = self.adaLN_linear(F.silu(c)).chunk(2, dim=-1)
        y = layer_norm(x, scale=self.norm1_scale, bias=self.norm1_bias)
        q, k, v = _qkv(self.self_attn_qkv(y), self.cfg.num_attention_heads)
        attn = dot_product_attention(q, k, v, txt_mask).flatten(2)
        x = x + self.self_attn_proj(attn) * gate_msa[:, None, :]
        y = layer_norm(x, scale=self.norm2_scale, bias=self.norm2_bias)
        y = self.mlp_out(F.silu(self.mlp_in(y)))
        return x + y * gate_mlp[:, None, :]


class HunyuanDoubleBlock(nn.Module):
    """hyvideo MMDoubleStreamBlock: image and text streams, each modulated
    by its own 6-way adaLN, joint attention over [image, text]."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dim, hd, mlp = cfg.hidden_size, cfg.attention_head_dim, cfg.mlp_dim
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", block_dense(cfg, dim, 6 * dim))
            setattr(self, f"{s}_attn_qkv", block_dense(cfg, dim, 3 * dim))
            setattr(self, f"{s}_attn_q_norm", RMSNorm(hd, param_dtype=cfg.param_dtype))
            setattr(self, f"{s}_attn_k_norm", RMSNorm(hd, param_dtype=cfg.param_dtype))
            setattr(self, f"{s}_attn_proj", block_dense(cfg, dim, dim))
            setattr(self, f"{s}_mlp_fc1", block_dense(cfg, dim, mlp))
            setattr(self, f"{s}_mlp_fc2", block_dense(cfg, mlp, dim))

    def _stream_qkv(self, s: str, x, shift, scale):
        q, k, v = _qkv(getattr(self, f"{s}_attn_qkv")(modulate(layer_norm(x), shift, scale)),
                       self.cfg.num_attention_heads)
        return getattr(self, f"{s}_attn_q_norm")(q), getattr(self, f"{s}_attn_k_norm")(k), v

    def _stream_out(self, s: str, x, attn, mods):
        _, _, g1, s2, sc2, g2 = mods
        x = x + g1[:, None] * getattr(self, f"{s}_attn_proj")(attn)
        y = modulate(layer_norm(x), s2, sc2)
        y = getattr(self, f"{s}_mlp_fc2")(F.gelu(getattr(self, f"{s}_mlp_fc1")(y),
                                                 approximate="tanh"))
        return x + g2[:, None] * y

    def forward(self, img, txt, vec, rope_cos, rope_sin, kv_mask):
        act = F.silu(vec)
        i_mods = self.img_mod(act).chunk(6, dim=-1)
        t_mods = self.txt_mod(act).chunk(6, dim=-1)
        iq, ik, iv = self._stream_qkv("img", img, *i_mods[:2])
        tq, tk, tv = self._stream_qkv("txt", txt, *t_mods[:2])
        iq = apply_rope(iq, rope_cos, rope_sin)
        ik = apply_rope(ik, rope_cos, rope_sin)
        attn = dot_product_attention(torch.cat([iq, tq], 1), torch.cat([ik, tk], 1),
                                     torch.cat([iv, tv], 1), kv_mask).flatten(2)
        si = img.shape[1]
        return (self._stream_out("img", img, attn[:, :si], i_mods),
                self._stream_out("txt", txt, attn[:, si:], t_mods))


class HunyuanSingleBlock(nn.Module):
    """hyvideo MMSingleStreamBlock over [image, text]: one fused linear for
    q / k / v and the GELU MLP's input, one for the output of both. RoPE
    turns the image rows alone: the tables the transformer hands it hold cos
    1 and sin 0 on the text rows, which leaves them as they are."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dim, hd, mlp = cfg.hidden_size, cfg.attention_head_dim, cfg.mlp_dim
        self.modulation = block_dense(cfg, dim, 3 * dim)
        self.linear1 = block_dense(cfg, dim, 3 * dim + mlp)
        self.q_norm = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.k_norm = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.linear2 = block_dense(cfg, dim + mlp, dim)

    def forward(self, x, vec, rope_cos, rope_sin, kv_mask):
        dim = self.cfg.hidden_size
        shift, scale, gate = self.modulation(F.silu(vec)).chunk(3, dim=-1)
        y = self.linear1(modulate(layer_norm(x), shift, scale))
        q, k, v = _qkv(y[..., :3 * dim], self.cfg.num_attention_heads)
        q = apply_rope(self.q_norm(q), rope_cos, rope_sin)
        k = apply_rope(self.k_norm(k), rope_cos, rope_sin)
        attn = dot_product_attention(q, k, v, kv_mask).flatten(2)
        out = self.linear2(torch.cat([attn, F.gelu(y[..., 3 * dim:], approximate="tanh")], -1))
        return x + gate[:, None] * out


def text_rope_rows(cos: torch.Tensor, sin: torch.Tensor, txt_len: int):
    """The image rows' RoPE tables followed by txt_len rows of cos 1, sin 0."""
    return (torch.cat([cos, cos.new_ones(txt_len, cos.shape[1])]),
            torch.cat([sin, sin.new_zeros(txt_len, sin.shape[1])]))


def masked_mean(states: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean of states [B, S, D] over the valid rows of mask [B, S], in
    f32 (an empty row's mean is 0)."""
    m = mask.float()
    return (states.float() * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp(min=1.0)


class HunyuanStacks(nn.Module):
    """What HunyuanVideo and HunyuanImage-2.1 share: the token refiner's
    conditioning and blocks, the double and single block stacks and the
    adaLN head. The families embed the image, the timestep and the text
    themselves."""

    def _init_stacks(self, cfg, text_dim: int, out_features: int):
        dim = cfg.hidden_size
        self.txt_in_proj = plain_dense(cfg, text_dim, dim)
        self.refiner_t_embed = MLPEmbedder(cfg, 256)
        self.refiner_c_embed = MLPEmbedder(cfg, text_dim)
        self.refiner = nn.ModuleList([TokenRefinerBlock(cfg) for _ in range(cfg.refiner_layers)])
        self.double_blocks = nn.ModuleList([HunyuanDoubleBlock(cfg)
                                            for _ in range(cfg.num_layers)])
        self.single_blocks = nn.ModuleList([HunyuanSingleBlock(cfg)
                                            for _ in range(cfg.num_single_layers)])
        self.final_mod = plain_dense(cfg, dim, 2 * dim)
        self.final_linear = plain_dense(cfg, dim, out_features, dtype=torch.float32)

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def refine_text(self, text_states, text_mask, temb):
        """txt_in: the text projected, then the refiner blocks conditioned on
        the timestep embedding temb [B, 256] and the masked mean text."""
        cfg = self.cfg
        txt = self.txt_in_proj(text_states.to(cfg.dtype))
        c = (self.refiner_t_embed(temb.to(cfg.dtype))
             + self.refiner_c_embed(masked_mean(text_states, text_mask).to(cfg.dtype)))
        for block in self.refiner:
            txt = block(txt, c, text_mask)
        return txt

    def run_blocks(self, img, txt, vec, rope_cos, rope_sin, text_mask):
        """The double then the single blocks; the image rows of the result."""
        img_len = img.shape[1]
        ones = torch.ones((img.shape[0], img_len), dtype=torch.int32, device=img.device)
        kv_mask = torch.cat([ones, text_mask.to(torch.int32)], dim=1)
        for block in self.double_blocks:
            img, txt = self._run(block, img, txt, vec, rope_cos, rope_sin, kv_mask)
        x = torch.cat([img, txt], dim=1)
        cos, sin = text_rope_rows(rope_cos, rope_sin, txt.shape[1])
        for block in self.single_blocks:
            x = self._run(block, x, vec, cos, sin, kv_mask)
        return x[:, :img_len]

    def head(self, img, vec):
        shift, scale = self.final_mod(F.silu(vec)).chunk(2, dim=-1)
        return self.final_linear(modulate(layer_norm(img), shift, scale))


def grid_ids(*sizes: int, device=None) -> torch.Tensor:
    """Position ids [prod(sizes), len(sizes)] of a row-major grid."""
    axes = [torch.arange(n, device=device) for n in sizes]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, len(sizes))


def unpatchify(out: torch.Tensor, channels: int, grid, patch) -> torch.Tensor:
    """hyvideo's unpatchify: tokens [B, prod(grid), C * prod(patch)] whose
    features are ordered (c, *patch) -> [B, C, *(grid * patch)]."""
    b, n = len(grid), len(patch)
    x = out.reshape(out.shape[0], *grid, channels, *patch)
    # (B, g0.., C, p0..) -> (B, C, g0, p0, g1, p1, ...)
    perm = [0, b + 1] + [i for a in range(n) for i in (1 + a, b + 2 + a)]
    x = x.permute(perm)
    return x.reshape(out.shape[0], channels, *(g * p for g, p in zip(grid, patch)))


class HunyuanVideoTransformer(HunyuanStacks):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.img_in = PatchEmbed3d(cfg.in_channels, dim, cfg.patch_size, dtype=cfg.dtype,
                                   param_dtype=cfg.param_dtype)
        self.time_in = MLPEmbedder(cfg, 256)
        self.vector_in = MLPEmbedder(cfg, cfg.pooled_projection_dim)
        self.guidance_in = MLPEmbedder(cfg, 256) if cfg.guidance_embeds else None
        self._init_stacks(cfg, cfg.text_dim, cfg.out_channels * math.prod(cfg.patch_size))

    def forward(self, x, t, text_states, text_mask, pooled, guidance=None):
        """x [B, C, F, H, W] latents, t [B] in [0, 1,000], text_states [B, S,
        text_dim] (the cropped LLaVA states), text_mask [B, S], pooled [B,
        768] (CLIP-L), guidance [B] (x 1,000) -> [B, C, F, H, W] f32."""
        cfg = self.cfg
        _, _, f, h, w = x.shape
        pt, ph, pw = cfg.patch_size
        grid = (f // pt, h // ph, w // pw)
        img = self.img_in(x)
        temb = sinusoidal_timestep_embedding(t, 256)
        vec = self.time_in(temb.to(cfg.dtype)) + self.vector_in(pooled.to(cfg.dtype))
        if self.guidance_in is not None and guidance is not None:
            vec = vec + self.guidance_in(sinusoidal_timestep_embedding(guidance, 256)
                                         .to(cfg.dtype))
        txt = self.refine_text(text_states, text_mask, temb)
        cos, sin = rope_frequencies(grid_ids(*grid, device=x.device), cfg.rope_axes_dim,
                                    cfg.rope_theta)
        img = self.run_blocks(img, txt, vec, cos, sin, text_mask)
        return unpatchify(self.head(img, vec), cfg.out_channels, grid, cfg.patch_size)

