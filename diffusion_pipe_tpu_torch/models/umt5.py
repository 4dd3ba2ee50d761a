"""UMT5 encoder, Wan's text encoder, as a PyTorch module.

Counterpart of diffusion_pipe_tpu/models/umt5.py: the token embedding, then
blocks of T5 layer norm (RMS, no mean), self-attention without the 1/sqrt(d)
scaling plus a per-layer relative-position bias over bidirectional buckets,
and a gated-GELU feed-forward, then the final T5 norm. The attention is
plain torch (logits in f32, a [B, S] key mask by the JAX mask value), as the
JAX module computes it with einsum outside any Pallas kernel; the encoder
runs once per caption in the caching phase, or without gradients in the
step when text embeddings are not cached.

Parameter names follow the JAX module with `block_{i}` as `blocks.{i}`
(interop.tree_to_state_dict maps one onto the other): `norm1`, `norm2`
[dim], `pos_embedding` [num_buckets, heads], linears `attn_q/k/v/o`,
`ffn_gate`, `ffn_fc1`, `ffn_fc2` (no bias, torch's [out, in] weight),
`token_embedding.weight` [vocab, dim] and `final_norm` [dim]. A linear's
weight may be stored in float8 (text_encoder_fp8, cast_te_params_fp8): it
is cast to the compute dtype at use.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the JAX package's mask value for padded keys (ops/flash_attention.py)
_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True)
class UMT5Config:
    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def xxl(**kw) -> "UMT5Config":
        return UMT5Config(**kw)

    @staticmethod
    def tiny(**kw) -> "UMT5Config":
        d = dict(vocab=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=4, num_layers=2,
                 dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return UMT5Config(**d)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int,
                              max_dist: int) -> np.ndarray:
    """Bidirectional T5 bucketing [qlen, klen] (the JAX function's numpy)."""
    ctx = np.arange(qlen)[:, None]
    mem = np.arange(klen)[None, :]
    rel_pos = mem - ctx
    nb = num_buckets // 2
    rel_buckets = (rel_pos > 0).astype(np.int64) * nb
    rel_pos = np.abs(rel_pos)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel_pos, 1) / max_exact)
        / math.log(max_dist / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    rel_buckets += np.where(rel_pos < max_exact, rel_pos, large)
    return rel_buckets


def _t5_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
    return (scale.float() * xf).to(x.dtype)


class _Linear(nn.Module):
    """A bias-free linear whose weight may be stored in another dtype
    (float8 under text_encoder_fp8), cast to the input's at use."""

    def __init__(self, in_features: int, features: int, param_dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, dtype=param_dtype))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype))


class UMT5Block(nn.Module):
    def __init__(self, cfg: UMT5Config):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.norm1 = nn.Parameter(torch.empty(cfg.dim, dtype=pd))
        self.norm2 = nn.Parameter(torch.empty(cfg.dim, dtype=pd))
        self.pos_embedding = nn.Parameter(torch.empty(cfg.num_buckets, cfg.num_heads, dtype=pd))
        for name in ("attn_q", "attn_k", "attn_v"):
            setattr(self, name, _Linear(cfg.dim, cfg.dim_attn, pd))
        self.attn_o = _Linear(cfg.dim_attn, cfg.dim, pd)
        self.ffn_gate = _Linear(cfg.dim, cfg.dim_ffn, pd)
        self.ffn_fc1 = _Linear(cfg.dim, cfg.dim_ffn, pd)
        self.ffn_fc2 = _Linear(cfg.dim_ffn, cfg.dim, pd)

    def forward(self, x, mask, rel_buckets):
        """x [B, S, dim] in cfg.dtype; mask [B, S] (nonzero: a real token) or
        None; rel_buckets [S, S] long."""
        cfg = self.cfg
        b, s, _ = x.shape
        heads, hd = cfg.num_heads, cfg.dim_attn // cfg.num_heads
        pos_bias = self.pos_embedding[rel_buckets].permute(2, 0, 1)[None].float()

        y = _t5_norm(x, self.norm1)
        q, k, v = (lin(y).reshape(b, s, heads, hd).transpose(1, 2)
                   for lin in (self.attn_q, self.attn_k, self.attn_v))
        logits = q.float() @ k.float().transpose(-1, -2) + pos_bias  # [B, H, S, S]
        if mask is not None:
            logits = logits.masked_fill(~(mask > 0)[:, None, None, :], _MASK_VALUE)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        o = (attn @ v).transpose(1, 2).reshape(b, s, cfg.dim_attn)
        x = x + self.attn_o(o)

        y = _t5_norm(x, self.norm2)
        h = self.ffn_fc1(y) * F.gelu(self.ffn_gate(y), approximate="tanh")
        return x + self.ffn_fc2(h)


class UMT5Encoder(nn.Module):
    def __init__(self, cfg: UMT5Config):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab, cfg.dim, dtype=cfg.param_dtype)
        self.blocks = nn.ModuleList([UMT5Block(cfg) for _ in range(cfg.num_layers)])
        self.final_norm = nn.Parameter(torch.empty(cfg.dim, dtype=cfg.param_dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded weights (no checkpoint): normal embeddings and linears of
        variance 1/fan_in, the relative-position tables normal with the JAX
        init's std, norm scales one. Drawn in f32, then cast."""
        cfg = self.cfg

        def normal_(w, std):
            tmp = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                              device=w.device)
            w.copy_(tmp.mul_(std))

        normal_(self.token_embedding.weight, 1.0)
        self.final_norm.fill_(1.0)
        for blk in self.blocks:
            blk.norm1.fill_(1.0)
            blk.norm2.fill_(1.0)
            normal_(blk.pos_embedding, (2 * cfg.num_buckets * cfg.num_heads) ** -0.5)
            for m in blk.modules():
                if isinstance(m, _Linear):
                    normal_(m.weight, m.weight.shape[1] ** -0.5)

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids [B, S] int; mask [B, S] -> hidden states [B, S, dim] in cfg.dtype."""
        cfg = self.cfg
        x = self.token_embedding(ids.long()).to(cfg.dtype)
        s = ids.shape[1]
        rel = torch.from_numpy(relative_position_buckets(s, s, cfg.num_buckets, cfg.max_dist))
        rel = rel.to(x.device)
        for blk in self.blocks:
            x = blk(x, mask, rel)
        return _t5_norm(x, self.final_norm).to(cfg.dtype)


def convert_umt5_comfy(sd: Mapping[str, torch.Tensor], cfg: UMT5Config) -> Dict[str, torch.Tensor]:
    """ComfyUI-repacked UMT5 keys -> the port's state dict:
    encoder.block.N.layer.0.SelfAttention.{q,k,v,o,relative_attention_bias},
    layer.0.layer_norm, layer.1.DenseReluDense.{wi_0 (gate), wi_1 (fc1),
    wo}, layer.1.layer_norm, shared (the embedding) and
    encoder.final_layer_norm. torch's [out, in] weights map by name."""
    out = {"token_embedding.weight": sd["shared.weight"],
           "final_norm": sd["encoder.final_layer_norm.weight"]}
    names = {
        "norm1": "layer.0.layer_norm.weight",
        "attn_q.weight": "layer.0.SelfAttention.q.weight",
        "attn_k.weight": "layer.0.SelfAttention.k.weight",
        "attn_v.weight": "layer.0.SelfAttention.v.weight",
        "attn_o.weight": "layer.0.SelfAttention.o.weight",
        "pos_embedding": "layer.0.SelfAttention.relative_attention_bias.weight",
        "norm2": "layer.1.layer_norm.weight",
        "ffn_gate.weight": "layer.1.DenseReluDense.wi_0.weight",
        "ffn_fc1.weight": "layer.1.DenseReluDense.wi_1.weight",
        "ffn_fc2.weight": "layer.1.DenseReluDense.wo.weight",
    }
    for i in range(cfg.num_layers):
        for ours, theirs in names.items():
            out[f"blocks.{i}.{ours}"] = sd[f"encoder.block.{i}.{theirs}"]
    return out
