"""The CLIP text towers that SDXL runs inside its training step.

Counterpart of the transformers Flax CLIP text models the JAX SDXL pipeline
calls (FlaxCLIPTextModel for CLIP-L, FlaxCLIPTextModelWithProjection for
OpenCLIP bigG): a plain nn.Module whose state_dict keys are transformers'
torch keys (`text_model.embeddings.token_embedding.weight`,
`text_model.encoder.layers.{i}.self_attn.q_proj.weight`, ...,
`text_projection.weight`), so a diffusers `text_encoder` /
`text_encoder_2` folder loads as it is. The towers are the port's own and
not transformers' modules: they sit in the train state and train under
full fine-tuning.

f32, as the JAX package's Flax towers. Pre-LN transformer with a causal
softmax attention (a plain product, as the JAX package's Flax CLIP
computes it; the flash kernels take no causal mask), quick_gelu (CLIP-L)
or exact gelu (bigG) MLPs, a final layer norm,
and transformers' pooled-token rule: argmax(ids) when eos_token_id == 2,
else the first position holding eos_token_id (position 0 when none does).
`forward` returns (hidden_states, pooled): every layer's input and the
last layer's output, before the final norm, [n_layers + 1] entries of
[B, S, width]; pooled [B, width] after the final norm, projected when the
tower has a text_projection.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import lecun_normal_


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    with_projection: bool = False

    @staticmethod
    def clip_l() -> "CLIPTextConfig":
        """CLIP ViT-L/14's text tower (SDXL's text_encoder)."""
        return CLIPTextConfig()

    @staticmethod
    def open_clip_bigg() -> "CLIPTextConfig":
        """OpenCLIP ViT-bigG/14's text tower with its projection (SDXL's
        text_encoder_2)."""
        return CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                              num_attention_heads=20, projection_dim=1280, hidden_act="gelu",
                              with_projection=True)

    @staticmethod
    def tiny(**kw) -> "CLIPTextConfig":
        """The JAX SDXL pipeline's `_tiny` towers."""
        return CLIPTextConfig(**{**dict(vocab_size=256, hidden_size=16, intermediate_size=32,
                                        num_hidden_layers=2, num_attention_heads=2,
                                        projection_dim=16), **kw})

    @staticmethod
    def from_json(jc: dict, with_projection: bool) -> "CLIPTextConfig":
        """From a transformers config.json."""
        keys = {f.name for f in dataclasses.fields(CLIPTextConfig)} - {"with_projection"}
        return CLIPTextConfig(**{k: jc[k] for k in keys if k in jc},
                              with_projection=with_projection)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise NotImplementedError(f"CLIP activation {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.heads

        def heads(t):
            return t.reshape(b, s, self.heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd) + causal_bias
        o = torch.softmax(logits, dim=-1) @ v
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _act(cfg.hidden_act)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)

    def forward(self, x, causal_bias):
        x = x + self.self_attn(self.layer_norm1(x), causal_bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """CLIP-L (with_projection False) or bigG (True), see module docstring."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)
        self.text_projection = (nn.Linear(config.hidden_size, config.projection_dim, bias=False)
                                if config.with_projection else None)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights at the real shapes: normal embeddings
        (std 0.02), lecun-normal linears with zero biases, layer norms one
        and zero."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                w = torch.randn(m.weight.shape, generator=generator, device=m.weight.device)
                m.weight.copy_(w * 0.02)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def pooled_positions(self, ids: torch.Tensor) -> torch.Tensor:
        eos = self.config.eos_token_id
        if eos == 2:
            return ids.argmax(dim=-1)
        return (ids == eos).int().argmax(dim=-1)

    def forward(self, ids: torch.Tensor) -> Tuple[list, torch.Tensor]:
        ids = ids.long()
        tm = self.text_model
        x = tm.embeddings(ids)
        s = ids.shape[1]
        causal = torch.full((s, s), float("-inf"), device=ids.device).triu(diagonal=1)
        hidden = [x]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
            hidden.append(x)
        last = tm.final_layer_norm(x)
        pooled = last[torch.arange(ids.shape[0], device=ids.device), self.pooled_positions(ids)]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return hidden, pooled
