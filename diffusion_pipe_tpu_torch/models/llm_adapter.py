"""Anima's trainable LLMAdapter: Qwen3-0.6B states -> the old-T5 embedding
space that the MiniTrainDIT was trained on.

Counterpart of diffusion_pipe_tpu/models/llm_adapter.py. The T5 token
embeddings of the caption are the query stream (through in_proj when the
widths differ), refined by blocks of optional self-attention over the T5
stream (masked by target_mask), cross-attention to the Qwen states (masked
by source_mask) and a GELU MLP, each behind an RMS pre-norm; then out_proj
and an RMS norm. The attentions have bias-free q / k / v / o, per-head RMS
q / k norms and rotate-half RoPE (cast to x's dtype) on both sides.

The attention is a plain product, as the JAX module computes it: einsum
logits in f32 over sqrt(D), masked keys filled with the f32 minimum,
softmax, einsum. A row whose keys are all masked (an empty caption) gets a
uniform softmax, as in JAX. It is no ops/attention call in either package:
no kernel computes it.

Parameters are f32 (LLMAdapterConfig's dtypes) whatever the DiT's dtype.
Module names are the reference checkpoint's (`blocks.{i}.cross_attn.q_proj`,
`blocks.{i}.mlp.0`), the norms' `weight` as the port's RMSNorm `scale`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .layers import LoraDense, RMSNorm


@dataclasses.dataclass(frozen=True)
class LLMAdapterConfig:
    source_dim: int = 1024      # Qwen3-0.6B's width
    target_dim: int = 1024      # the T5 width the DiT takes
    model_dim: int = 1024
    num_layers: int = 6
    num_heads: int = 16
    vocab: int = 32128          # T5's vocabulary
    self_attn: bool = False
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.num_heads

    @staticmethod
    def tiny(**kw) -> "LLMAdapterConfig":
        d = dict(source_dim=16, target_dim=24, model_dim=32, num_layers=2, num_heads=4,
                 vocab=64)
        d.update(kw)
        return LLMAdapterConfig(**d)


def _rope(n: int, head_dim: int, theta: float, device=None):
    """cos / sin [n, head_dim] f32 of positions 0..n-1, the frequencies
    computed in numpy f32 as the JAX function computes them."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    freqs = np.arange(n, dtype=np.float32)[:, None] * inv[None, :]
    emb = torch.from_numpy(np.concatenate([freqs, freqs], axis=-1)).to(device)
    return torch.cos(emb), torch.sin(emb)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in x's dtype; x [B, S, H, D]."""
    c, s = cos[None, :, None, :].to(x.dtype), sin[None, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return x * c + torch.cat([-x2, x1], dim=-1) * s


class AdapterAttention(nn.Module):
    def __init__(self, cfg: LLMAdapterConfig, context_dim: int):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        dd = dict(use_bias=False, dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.q_proj = LoraDense(cfg.model_dim, inner, **dd)
        self.k_proj = LoraDense(context_dim, inner, **dd)
        self.v_proj = LoraDense(context_dim, inner, **dd)
        self.o_proj = LoraDense(inner, cfg.model_dim, **dd)
        self.q_norm = RMSNorm(cfg.head_dim, 1e-6, cfg.param_dtype)
        self.k_norm = RMSNorm(cfg.head_dim, 1e-6, cfg.param_dtype)

    def forward(self, x, context, rope_q, rope_k, kv_mask=None):
        h, d = self.cfg.num_heads, self.cfg.head_dim
        b, sq = x.shape[:2]
        sk = context.shape[1]
        q = _apply_rope(self.q_norm(self.q_proj(x).reshape(b, sq, h, d)), *rope_q)
        k = _apply_rope(self.k_norm(self.k_proj(context).reshape(b, sk, h, d)), *rope_k)
        v = self.v_proj(context).reshape(b, sk, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(d)
        if kv_mask is not None:
            logits = logits.masked_fill(~(kv_mask > 0)[:, None, None, :],
                                        float(torch.finfo(torch.float32).min))
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, sq, h * d)
        return self.o_proj(o)


class AdapterBlock(nn.Module):
    def __init__(self, cfg: LLMAdapterConfig):
        super().__init__()
        dim, pd = cfg.model_dim, cfg.param_dtype
        if cfg.self_attn:
            self.norm_self_attn = RMSNorm(dim, 1e-6, pd)
            self.self_attn = AdapterAttention(cfg, dim)
        self.norm_cross_attn = RMSNorm(dim, 1e-6, pd)
        self.cross_attn = AdapterAttention(cfg, cfg.source_dim)
        self.norm_mlp = RMSNorm(dim, 1e-6, pd)
        dd = dict(dtype=cfg.dtype, param_dtype=pd)
        self.mlp = nn.Sequential(LoraDense(dim, 4 * dim, **dd), nn.GELU(),
                                 LoraDense(4 * dim, dim, **dd))

    def forward(self, x, ctx, rope_q, rope_k, target_mask, source_mask):
        if hasattr(self, "self_attn"):
            y = self.norm_self_attn(x)
            x = x + self.self_attn(y, y, rope_q, rope_q, target_mask)
        x = x + self.cross_attn(self.norm_cross_attn(x), ctx, rope_q, rope_k, source_mask)
        return x + self.mlp(self.norm_mlp(x))


class LLMAdapter(nn.Module):
    def __init__(self, cfg: LLMAdapterConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab, cfg.target_dim, dtype=cfg.param_dtype)
        if cfg.model_dim != cfg.target_dim:
            self.in_proj = LoraDense(cfg.target_dim, cfg.model_dim, dtype=cfg.dtype,
                                     param_dtype=cfg.param_dtype)
        self.blocks = nn.ModuleList([AdapterBlock(cfg) for _ in range(cfg.num_layers)])
        self.out_proj = LoraDense(cfg.model_dim, cfg.target_dim, dtype=cfg.dtype,
                                  param_dtype=cfg.param_dtype)
        self.norm = RMSNorm(cfg.target_dim, 1e-6, cfg.param_dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The embedding: normal draws of std 1 / sqrt(target_dim), in f32
        (flax's default embedding init); the rest init themselves."""
        w = self.embed.weight
        tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        w.copy_(tmp.normal_(0.0, self.cfg.target_dim ** -0.5, generator=generator))

    def forward(self, source_hidden_states, target_input_ids, target_mask=None,
                source_mask=None):
        """source_hidden_states [B, Ls, source_dim]; target_input_ids [B, Lt]
        -> [B, Lt, target_dim] in the adapter's dtype."""
        cfg = self.cfg
        x = self.embed(target_input_ids.long()).to(cfg.dtype)
        if hasattr(self, "in_proj"):
            x = self.in_proj(x)
        dev = x.device
        rope_q = _rope(x.shape[1], cfg.head_dim, cfg.rope_theta, dev)
        rope_k = _rope(source_hidden_states.shape[1], cfg.head_dim, cfg.rope_theta, dev)
        ctx = source_hidden_states.to(cfg.dtype)
        for block in self.blocks:
            x = block(x, ctx, rope_q, rope_k, target_mask, source_mask)
        return self.norm(self.out_proj(x))


def convert_llm_adapter(sd: Mapping[str, torch.Tensor],
                        cfg: LLMAdapterConfig) -> Dict[str, torch.Tensor]:
    """A reference LLMAdapter state dict -> the port module's (of cfg), its
    keys with or without the `llm_adapter.` prefix of an Anima checkpoint.
    The norms' `weight` become `scale`; the RoPE's inv_freq buffer is
    skipped. A LayerNorm bias (a layer_norm = True adapter, which Anima never
    builds) raises, as a key missing or one the module does not take does."""
    stripped = {(k[len("llm_adapter."):] if k.startswith("llm_adapter.") else k): v
                for k, v in sd.items() if not k.endswith("rotary_emb.inv_freq")}
    ln_bias = [k for k in stripped if k.endswith(".bias") and ".norm" in f".{k}"]
    if ln_bias:
        raise ValueError(f"LLMAdapter checkpoint has LayerNorm biases ({ln_bias[:3]}): "
                         "layer_norm = True adapters are not supported (Anima uses RMSNorm)")
    norms = ("norm", "q_norm", "k_norm", "norm_self_attn", "norm_cross_attn", "norm_mlp")
    out = {}
    for k, v in stripped.items():
        owner, _, leaf = k.rpartition(".")
        is_norm = leaf == "weight" and owner.rpartition(".")[2] in norms
        out[f"{owner}.scale" if is_norm else k] = v
    with torch.device("meta"):
        want = set(LLMAdapter(cfg).state_dict())
    missing, extra = sorted(want - set(out)), sorted(set(out) - want)
    if missing:
        raise KeyError(f"the LLMAdapter checkpoint lacks {len(missing)} keys, e.g. {missing[:8]}")
    if extra:
        raise KeyError(f"the LLMAdapter checkpoint: {len(extra)} keys that the adapter does not "
                       f"take, e.g. {extra[:8]}")
    return out


def export_llm_adapter(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port module's state dict (keys under `llm_adapter.`, as the
    trainer names them) -> the reference checkpoint's `llm_adapter.*`
    names, norms as `weight`, on the CPU: what convert_llm_adapter and the
    pipeline's load_weights read back."""
    out = {}
    for k, v in state_dict.items():
        if not k.startswith("llm_adapter."):
            continue
        if k.endswith(".scale"):
            k = k[: -len(".scale")] + ".weight"
        out[k] = v.detach().contiguous().cpu()
    return out

