"""Decoder-only LLM text encoders (Llama / Llama 3.1 / Qwen2 / Qwen2.5(-VL) /
Qwen3 / Qwen3-VL / Mistral / Gemma 2 / Gemma 3) as PyTorch modules, for
caption embeddings.

Counterpart of diffusion_pipe_tpu/models/llm_encoders.py: one configurable
decoder covers the family, the per-model differences being config flags
that `CausalLMConfig.from_hf_config` reads from a transformers config.json:
GQA widths, q/k/v biases (Qwen2), multimodal RoPE sections (Qwen2.5-VL),
Llama 3.1's scaled RoPE frequencies (rope_type "llama3"), per-head q/k RMS
norms (Qwen3, Qwen3-VL's text tower, Gemma 3), Gemma's (1 + w) RMS norms,
sandwich norms, embedding scale, query scale and logit soft-capping,
sliding-window layers and Gemma 3's local RoPE base. The JAX function reads
neither Llama 3.1's scaling nor Qwen3-VL's q/k norms; the port reads both,
as transformers does.

The attention is plain torch (f32 logits, the JAX package's finfo.min on
masked keys, an f32 softmax), as the JAX module computes it with einsums
outside any Pallas kernel: the mask is causal and padded, which no flash
kernel of the port serves. The encoder runs without gradients, once per
caption in the caching phase.

Parameter names follow the JAX module with `layer_{i}` as `layers.{i}`
(interop.tree_to_state_dict maps one onto the other): `token_embedding`,
per layer `attn_q/k/v/o`, `ffn_gate/up/down` (torch's [out, in] weight,
biases on q/k/v under qkv_bias), the norm scales `norm_in`,
`norm_post_attn`, `norm_pre_ffn`, `norm_post_ffn`, `q_norm`, `k_norm`, and
`final_norm`. A linear's weight may be stored in float8 (text_encoder_fp8,
text_encoders.cast_te_params_fp8): it is cast to the compute dtype at use.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_NEG = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class CausalLMConfig:
    vocab: int
    dim: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    ffn_dim: int
    act: str = "silu"  # "silu" (SwiGLU) | "gelu_tanh" (Gemma's GeGLU)
    rope_theta: float = 500000.0
    rope_local_theta: float = 10000.0  # the sliding layers' base (Gemma 3's local base)
    rope_scaling_factor: float = 1.0  # linear scaling on the full layers
    # Llama 3.1's frequency scaling (rope_type "llama3"): (factor,
    # low_freq_factor, high_freq_factor, original_max_position_embeddings);
    # () = none
    rope_llama3: Tuple[float, ...] = ()
    rms_eps: float = 1e-6
    qkv_bias: bool = False  # Qwen2 / 2.5
    qk_norm: bool = False  # Qwen3, Gemma 3
    gemma_norm: bool = False  # RMS scale (1 + w); embeddings x sqrt(dim)
    post_norms: bool = False  # Gemma 2 / 3 sandwich norms
    attn_softcap: float = 0.0  # Gemma 2: 50.0
    query_scale: Optional[float] = None  # Gemma: query_pre_attn_scalar ** -0.5
    sliding_window: int = 0
    layer_types: Tuple[str, ...] = ()  # per layer "full" | "sliding"; () = all one kind
    # Qwen2.5-VL's multimodal RoPE: contiguous (t, h, w) sections of the
    # head_dim / 2 frequencies; () = plain 1-D RoPE
    mrope_section: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16

    def layer_type(self, i: int) -> str:
        if not self.layer_types:
            return "sliding" if self.sliding_window else "full"
        return self.layer_types[i]

    @staticmethod
    def from_hf_config(cfg: dict, dtype=torch.bfloat16) -> "CausalLMConfig":
        """From a transformers config.json dict (a VL checkpoint's nested
        text_config is read over the top level)."""
        if "text_config" in cfg:
            cfg = {**cfg, **cfg["text_config"]}
        mt = cfg.get("model_type", "llama")
        heads, dim = cfg["num_attention_heads"], cfg["hidden_size"]
        kw: dict = dict(
            vocab=cfg["vocab_size"], dim=dim, num_layers=cfg["num_hidden_layers"],
            num_heads=heads, num_kv_heads=cfg.get("num_key_value_heads", heads),
            head_dim=cfg.get("head_dim") or dim // heads, ffn_dim=cfg["intermediate_size"],
            rope_theta=cfg.get("rope_theta", 10000.0), rms_eps=cfg.get("rms_norm_eps", 1e-6),
            dtype=dtype, param_dtype=dtype,
        )
        # a sliding layer keeps the model's RoPE base but in Gemma 3 (the JAX
        # function leaves it at 10,000, which changes Mistral's sliding layers)
        kw["rope_local_theta"] = kw["rope_theta"]
        sliding = cfg.get("sliding_window") or 0
        layer_types = cfg.get("layer_types")
        if mt in ("qwen2", "qwen2_vl", "qwen2_5_vl", "qwen2_5_vl_text"):
            kw["qkv_bias"] = True
            rs = cfg.get("rope_scaling") or {}
            if rs.get("mrope_section"):
                kw["mrope_section"] = tuple(rs["mrope_section"])
            # transformers slides only above max_window_layers; the text
            # towers that are cached turn it off
            sliding = 0
        elif mt in ("qwen3", "qwen3_vl", "qwen3_vl_text"):
            # Qwen3-VL's interleaved multimodal RoPE is plain RoPE on
            # text-only ids, which is all a caption encoder gives it
            kw["qk_norm"] = True
        elif mt == "gemma2":
            kw.update(act="gelu_tanh", gemma_norm=True, post_norms=True,
                      attn_softcap=cfg.get("attn_logit_softcapping") or 0.0,
                      query_scale=cfg.get("query_pre_attn_scalar", 256) ** -0.5)
            if layer_types is None and sliding:  # even layers slide, odd are full
                layer_types = ["sliding_attention" if i % 2 == 0 else "full_attention"
                               for i in range(kw["num_layers"])]
        elif mt in ("gemma3", "gemma3_text"):
            kw.update(act="gelu_tanh", gemma_norm=True, post_norms=True, qk_norm=True,
                      query_scale=cfg.get("query_pre_attn_scalar", 256) ** -0.5,
                      rope_local_theta=cfg.get("rope_local_base_freq", 10000.0))
            rs = cfg.get("rope_scaling") or {}
            if rs.get("rope_type", rs.get("type")) == "linear":
                kw["rope_scaling_factor"] = rs.get("factor", 1.0)
            if layer_types is None and sliding:  # five sliding, then one full
                pat = cfg.get("sliding_window_pattern", 6)
                layer_types = ["full_attention" if (i + 1) % pat == 0 else "sliding_attention"
                               for i in range(kw["num_layers"])]
        rs = cfg.get("rope_scaling") or {}
        if rs.get("rope_type", rs.get("type")) == "llama3":
            kw["rope_llama3"] = (float(rs["factor"]), float(rs["low_freq_factor"]),
                                 float(rs["high_freq_factor"]),
                                 float(rs["original_max_position_embeddings"]))
        if layer_types:
            kw["layer_types"] = tuple("sliding" if t.startswith("sliding") else "full"
                                      for t in layer_types)
        kw["sliding_window"] = sliding
        return CausalLMConfig(**kw)

    @staticmethod
    def qwen25_vl_7b(**over) -> "CausalLMConfig":
        """Qwen2.5-VL-7B-Instruct's text tower (its config.json)."""
        d = dict(vocab=152064, dim=3584, num_layers=28, num_heads=28, num_kv_heads=4,
                 head_dim=128, ffn_dim=18944, rope_theta=1000000.0, qkv_bias=True,
                 mrope_section=(16, 24, 24))
        d.update(over)
        return CausalLMConfig(**d)

    @staticmethod
    def tiny(**over) -> "CausalLMConfig":
        d = dict(vocab=256, dim=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                 ffn_dim=64, dtype=torch.float32, param_dtype=torch.float32)
        d.update(over)
        return CausalLMConfig(**d)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float, gemma: bool) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    s = scale.float()
    return (xf * (1.0 + s if gemma else s)).to(x.dtype)


def _inv_freq(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def _mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float, sections):
    """Qwen2.5-VL's multimodal RoPE tables [B, S, head_dim] f32 from
    position_ids [B, 3, S] (t, h, w): frequency j of the head_dim / 2 takes
    the axis of the section it falls in, the sections counted in frequency
    pairs and summing to head_dim / 2."""
    half = head_dim // 2
    axis_of = np.zeros((half,), np.int64)
    start = 0
    for ax, n in enumerate(sections):
        axis_of[start:start + n] = ax
        start += n
    dev = position_ids.device
    pos = position_ids.float()[:, torch.from_numpy(axis_of).to(dev)]  # [B, half, S]
    freqs = pos.transpose(1, 2) * torch.from_numpy(_inv_freq(head_dim, theta)).to(dev)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rope_cos_sin(s: int, head_dim: int, theta: float, scaling: float, device=None):
    """Rotate-half RoPE tables [S, head_dim] f32 at positions 0..S-1."""
    pos = np.arange(s, dtype=np.float32)
    freqs = torch.from_numpy((pos[:, None] / np.float32(scaling))
                             * _inv_freq(head_dim, theta)[None, :]).to(device)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _llama3_inv_freq(head_dim: int, theta: float, params, device=None) -> torch.Tensor:
    """Llama 3.1's inverse frequencies [head_dim / 2] f32, as transformers'
    _compute_llama3_parameters computes them: wavelengths above
    original_max / low_freq_factor divided by factor, those below
    original_max / high_freq_factor kept, the band between smoothed."""
    factor, low, high, old_len = params
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.int64, device=device)
                           .float() / head_dim))
    wavelen = 2 * math.pi / inv
    scaled = torch.where(wavelen > old_len / low, inv / factor, inv)
    smooth = (old_len / wavelen - low) / (high - low)
    smoothed = (1 - smooth) * scaled / factor + smooth * scaled
    medium = ~(wavelen < old_len / high) * ~(wavelen > old_len / low)
    return torch.where(medium, smoothed, scaled)


def _llama3_cos_sin(s: int, head_dim: int, theta: float, params, device=None):
    """Rotate-half RoPE tables [S, head_dim] f32 at positions 0..S-1 from
    Llama 3.1's scaled frequencies."""
    pos = torch.arange(s, dtype=torch.float32, device=device)
    freqs = pos[:, None] * _llama3_inv_freq(head_dim, theta, params, device)[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos / sin [S, D] or per batch [B, S, D] (mrope), cast
    to x's dtype as the JAX function does."""
    c = (cos[:, :, None] if cos.dim() == 3 else cos[None, :, None]).to(x.dtype)
    s = (sin[:, :, None] if sin.dim() == 3 else sin[None, :, None]).to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return x * c + torch.cat([-x2, x1], dim=-1) * s


class _Linear(nn.Module):
    """A linear whose weight may be stored in another dtype (float8 under
    text_encoder_fp8), cast with the bias to the compute dtype at use."""

    def __init__(self, in_features: int, features: int, param_dtype, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: CausalLMConfig, layer_idx: int):
        super().__init__()
        self.cfg, self.sliding = cfg, cfg.layer_type(layer_idx) == "sliding"
        pd, h, kv, d = cfg.param_dtype, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.attn_q = _Linear(cfg.dim, h * d, pd, cfg.qkv_bias)
        self.attn_k = _Linear(cfg.dim, kv * d, pd, cfg.qkv_bias)
        self.attn_v = _Linear(cfg.dim, kv * d, pd, cfg.qkv_bias)
        self.attn_o = _Linear(h * d, cfg.dim, pd)
        self.ffn_gate = _Linear(cfg.dim, cfg.ffn_dim, pd)
        self.ffn_up = _Linear(cfg.dim, cfg.ffn_dim, pd)
        self.ffn_down = _Linear(cfg.ffn_dim, cfg.dim, pd)
        norms = ["norm_in", "norm_post_attn"] + (
            ["norm_pre_ffn", "norm_post_ffn"] if cfg.post_norms else [])
        for name in norms:
            setattr(self, name, nn.Parameter(torch.empty(cfg.dim, dtype=pd)))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.empty(d, dtype=pd))
            self.k_norm = nn.Parameter(torch.empty(d, dtype=pd))

    def _norm(self, y, scale):
        return _rms(y, scale, self.cfg.rms_eps, self.cfg.gemma_norm)

    def forward(self, x, mask_full, mask_sliding, rope_full, rope_sliding):
        """x [B, S, dim]; masks [B or 1, 1, S, S] bool (True: attend)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        mask = mask_sliding if self.sliding else mask_full
        cos, sin = rope_sliding if self.sliding else rope_full

        y = self._norm(x, self.norm_in)
        q = self.attn_q(y).reshape(b, s, h, d)
        k = self.attn_k(y).reshape(b, s, kv, d)
        v = self.attn_v(y).reshape(b, s, kv, d)
        if cfg.qk_norm:
            q, k = self._norm(q, self.q_norm), self._norm(k, self.k_norm)
        q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        if kv != h:
            k = k.repeat_interleave(h // kv, dim=2)
            v = v.repeat_interleave(h // kv, dim=2)
        scale = cfg.query_scale if cfg.query_scale is not None else d ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        if cfg.attn_softcap > 0.0:
            logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
        logits = logits.masked_fill(~mask, _NEG)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, s, h * d)
        o = self.attn_o(o)
        if cfg.post_norms:
            o = self._norm(o, self.norm_post_attn)
        x = x + o

        y = self._norm(x, self.norm_pre_ffn if cfg.post_norms else self.norm_post_attn)
        gate = self.ffn_gate(y)
        gate = F.gelu(gate, approximate="tanh") if cfg.act == "gelu_tanh" else F.silu(gate)
        f = self.ffn_down(gate * self.ffn_up(y))
        if cfg.post_norms:
            f = self._norm(f, self.norm_post_ffn)
        return x + f


class CausalLM(nn.Module):
    """The decoder without its LM head.

    forward returns (final normed hidden [B, S, dim], hiddens), hiddens as
    transformers' output_hidden_states list when collect_hidden is set:
    entry 0 the embeddings, entry i the output of layer i - 1, the last
    entry the final normed state (the raw last layer's output is not
    exposed), so a family that reads an intermediate state indexes it as
    the reference does."""

    def __init__(self, cfg: CausalLMConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab, cfg.dim, dtype=cfg.param_dtype)
        self.layers = nn.ModuleList([DecoderLayer(cfg, i) for i in range(cfg.num_layers)])
        self.final_norm = nn.Parameter(torch.empty(cfg.dim, dtype=cfg.param_dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded weights (no checkpoint): normal embeddings and linears of
        variance 1/fan_in, zero biases, norm scales one (zero for Gemma's
        1 + w). Drawn in f32, then cast."""
        norm_fill = 0.0 if self.cfg.gemma_norm else 1.0
        for name, p in self.named_parameters():
            if p.dim() == 2:
                fan_in = p.shape[1]
                tmp = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                                  device=p.device)
                p.copy_(tmp.mul_(fan_in ** -0.5))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(norm_fill)

    def forward(self, ids: Optional[torch.Tensor] = None, attn_mask=None,
                collect_hidden: bool = False, input_embeds: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None):
        """ids [B, S] (or input_embeds [B, S, dim] with the vision tokens
        spliced in); attn_mask [B, S] (nonzero: a real token); position_ids
        [B, 3, S], Qwen2.5-VL's (t, h, w) ids under mrope_section."""
        cfg = self.cfg
        if input_embeds is not None:
            x = input_embeds.to(cfg.dtype)
        else:
            x = self.token_embedding(ids.long()).to(cfg.dtype)
        b, s = x.shape[:2]
        dev = x.device
        if cfg.gemma_norm:  # transformers rounds the normalizer to the compute dtype
            x = x * torch.tensor(cfg.dim ** 0.5, dtype=cfg.dtype)

        if position_ids is not None and cfg.mrope_section:
            rope_full = _mrope_cos_sin(position_ids.to(dev), cfg.head_dim, cfg.rope_theta,
                                       cfg.mrope_section)
            rope_sliding = rope_full
        elif cfg.rope_llama3:
            rope_full = _llama3_cos_sin(s, cfg.head_dim, cfg.rope_theta, cfg.rope_llama3, dev)
            rope_sliding = rope_full
        else:
            rope_full = _rope_cos_sin(s, cfg.head_dim, cfg.rope_theta,
                                      cfg.rope_scaling_factor, dev)
            rope_sliding = _rope_cos_sin(s, cfg.head_dim, cfg.rope_local_theta, 1.0, dev)

        idx = torch.arange(s, device=dev)
        causal = (idx[None, :] <= idx[:, None])[None]  # [1, S, S]
        if attn_mask is not None:
            causal = causal & (attn_mask.to(dev) > 0)[:, None, :]
        mask_full = causal[:, None]
        mask_sliding = mask_full
        if cfg.sliding_window:
            mask_sliding = mask_full & ((idx[:, None] - idx[None, :]) < cfg.sliding_window)

        hiddens: List[torch.Tensor] = [x] if collect_hidden else []
        for layer in self.layers:
            x = layer(x, mask_full, mask_sliding, rope_full, rope_sliding)
            if collect_hidden:
                hiddens.append(x)
        out = _rms(x, self.final_norm, cfg.rms_eps, cfg.gemma_norm)
        if collect_hidden:
            hiddens[-1] = out
        return out, hiddens


# non-weight buffers a checkpoint may hold under the text tower's prefix
BUFFER_SUFFIXES = ("rotary_emb.inv_freq", "rotary_emb_local.inv_freq")


def convert_hf_causal_lm(sd: Mapping[str, torch.Tensor], cfg: CausalLMConfig,
                         prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """A transformers Llama / Qwen / Mistral / Gemma state dict -> the
    port's CausalLM state dict. `prefix` is the outer module path: "model."
    for a plain LM, "model.language_model." or "language_model.model." in
    a VL checkpoint. torch's [out, in] weights keep their layout. Raises
    KeyError naming the missing keys, and the keys under `prefix` that it
    does not take (the non-weight buffers of BUFFER_SUFFIXES aside), as the
    transformer loaders do (models/weights.py)."""
    names = {
        "attn_q": "self_attn.q_proj", "attn_k": "self_attn.k_proj",
        "attn_v": "self_attn.v_proj", "attn_o": "self_attn.o_proj",
        "ffn_gate": "mlp.gate_proj", "ffn_up": "mlp.up_proj", "ffn_down": "mlp.down_proj",
    }
    norms = {"norm_in": "input_layernorm", "norm_post_attn": "post_attention_layernorm"}
    if cfg.post_norms:
        norms.update(norm_pre_ffn="pre_feedforward_layernorm",
                     norm_post_ffn="post_feedforward_layernorm")
    if cfg.qk_norm:
        norms.update(q_norm="self_attn.q_norm", k_norm="self_attn.k_norm")
    want = {"token_embedding.weight": "embed_tokens.weight", "final_norm": "norm.weight"}
    for i in range(cfg.num_layers):
        for ours, theirs in names.items():
            want[f"layers.{i}.{ours}.weight"] = f"layers.{i}.{theirs}.weight"
            if cfg.qkv_bias and ours in ("attn_q", "attn_k", "attn_v"):
                want[f"layers.{i}.{ours}.bias"] = f"layers.{i}.{theirs}.bias"
        for ours, theirs in norms.items():
            want[f"layers.{i}.{ours}"] = f"layers.{i}.{theirs}.weight"
    missing = [prefix + k for k in want.values() if prefix + k not in sd]
    if missing:
        raise KeyError(f"LLM checkpoint lacks {len(missing)} keys, e.g. {missing[:5]}")
    taken = {prefix + k for k in want.values()}
    untaken = [k for k in sd if k.startswith(prefix) and k not in taken
               and not k.endswith(BUFFER_SUFFIXES)]
    if untaken:
        raise KeyError(f"LLM checkpoint holds {len(untaken)} keys under {prefix!r} that the "
                       f"model does not take, e.g. {untaken[:5]}")
    return {ours: sd[prefix + theirs] for ours, theirs in want.items()}


def detect_prefix(sd: Mapping[str, torch.Tensor], default: str = "model.") -> str:
    """The outer module path of a (VL) checkpoint's text tower."""
    for cand in (default, "model.language_model.", "language_model.model.", "model.text_model.",
                 ""):
        if any(k.startswith(cand + "layers.") for k in sd):
            return cand
    raise KeyError("no decoder layers ('<prefix>layers.N.') in the LLM checkpoint")


def load_causal_lm(path, dtype=torch.bfloat16, device=None, prefix: str = "model.",
                   fp8: bool = False, sd: Optional[Mapping[str, torch.Tensor]] = None):
    """(CausalLM on `device` in `dtype`, its config, the checkpoint's dict)
    from a transformers folder (config.json and safetensors); fp8 stores
    the 2-D weights but the embedding in float8 (text_encoder_fp8)."""
    from .text_encoders import cast_te_params_fp8
    from .weights import load_safetensors_dir

    hf_cfg = json.loads((Path(path) / "config.json").read_text())
    cfg = CausalLMConfig.from_hf_config(hf_cfg, dtype=dtype)
    if sd is None:
        sd = load_safetensors_dir(str(path))
    ours = convert_hf_causal_lm(sd, cfg, prefix=detect_prefix(sd, prefix))
    ours = {k: v.to(dtype) for k, v in ours.items()}
    if fp8:
        ours = cast_te_params_fp8(ours)
    with torch.device("meta"):
        model = CausalLM(cfg)
    model = model.to_empty(device=device or "cpu")
    for name, p in model.named_parameters():  # fp8 weights keep their storage dtype
        if ours[name].dtype != p.dtype:
            owner, leaf = name.rsplit(".", 1)
            setattr(model.get_submodule(owner), leaf, nn.Parameter(
                torch.empty_like(ours[name], device=p.device), requires_grad=False))
    model.load_state_dict(ours)
    return model.eval().requires_grad_(False), cfg, hf_cfg, sd


class LLMTextEncoder:
    """A frozen decoder LM as a caption encoder for the caching phase.

    As the reference handles prompt templates: the template wraps each
    caption (LLaVA / Qwen chat templates), `crop_start` leading tokens are
    dropped from the hidden states and the mask (HunyuanVideo's
    crop_start, Qwen-Image's drop_idx), and `hidden_layer` picks the state
    that feeds the DiT (-1: the final normed output; k: index k of the
    transformers-style hidden_states list). `hidden_layers`, when given,
    replaces it: the states of those indices are stacked per token along
    the features (FLUX.2's layers 10, 20 and 30 of Mistral-3). Weights and
    tokenizer load at the first call from a transformers folder (a
    Mistral3ForConditionalGeneration's language model too: its nested
    text_config and longer key prefix are found; its vision tower is not
    loaded); the text tower's prefix is found in the checkpoint.
    stack_layers gives every layer's output instead, stacked along a new
    axis: [B, num_layers, S, dim], transformers' hidden_states[1:] (HiDream's
    Llama-3.1 states, one a block). A tokenizer without a pad token pads
    with its EOS token, as the reference pads Llama 3.1."""

    def __init__(self, path: str, max_length: int, template: str = "{}",
                 crop_start: int = 0, hidden_layer: int = -1,
                 tokenizer_path: Optional[str] = None, dtype=torch.bfloat16,
                 hf_prefix: str = "model.", fp8: bool = False, device=None,
                 hidden_layers: Tuple[int, ...] = (), stack_layers: bool = False):
        self.path, self.max_length, self.template = Path(path), max_length, template
        self.crop_start, self.hidden_layer = crop_start, hidden_layer
        self.hidden_layers, self.stack_layers = tuple(hidden_layers), stack_layers
        self.tokenizer_path = tokenizer_path or str(path)
        self.dtype, self.hf_prefix, self.fp8 = dtype, hf_prefix, fp8
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.model = self.tokenizer = None

    def _load(self):
        if self.model is not None:
            return
        from transformers import AutoTokenizer

        self.model = load_causal_lm(self.path, self.dtype, self.device, self.hf_prefix,
                                    self.fp8)[0]
        self.tokenizer = AutoTokenizer.from_pretrained(str(self.tokenizer_path))
        if self.tokenizer.pad_token is None:
            self.tokenizer.pad_token = self.tokenizer.eos_token

    @torch.no_grad()
    def encode(self, captions, return_mask: bool = True):
        """captions -> hidden states [B, max_length, dim] f32 on the CPU
        ([B, num_layers, max_length, dim] under stack_layers), and the mask
        [B, max_length] int64, after the crop."""
        self._load()
        enc = self.tokenizer([self.template.format(c) for c in captions],
                             padding="max_length", truncation=True,
                             max_length=self.max_length + self.crop_start, return_tensors="pt")
        ids, mask = enc["input_ids"].to(self.device), enc["attention_mask"].to(self.device)
        h = self.hidden_states(ids, mask)
        h, mask = h[..., self.crop_start:, :].float().cpu(), mask[:, self.crop_start:].cpu()
        return (h, mask) if return_mask else h

    def hidden_states(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The state(s) that feed the DiT for token ids [B, S] and their mask."""
        if self.stack_layers:
            return torch.stack(self.model(ids, mask, collect_hidden=True)[1][1:], dim=1)
        layers = self.hidden_layers or (self.hidden_layer,)
        out, hiddens = self.model(ids, mask, collect_hidden=layers != (-1,))
        return torch.cat([out if k == -1 else hiddens[k] for k in layers], dim=-1)
