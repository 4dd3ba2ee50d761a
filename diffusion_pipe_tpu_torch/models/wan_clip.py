"""Wan i2v's CLIP vision tower (the ViT-H/14 visual path of XLM-RoBERTa-CLIP)
as a PyTorch module.

Counterpart of diffusion_pipe_tpu/models/wan_clip.py: the first frame
resized to 224 px (bicubic, antialiased: jax.image.resize's weights,
`resize_weights` below), mapped from [-1, 1] to the CLIP mean/std
normalisation, a 14 px patch embedding (256 patches + a class token = 257
tokens of width 1280), a pre-norm, then the first 31 of the 32 pre-norm
blocks (16 heads, exact GELU) with no post-norm or head: the 257 x 1280
tokens feed the Wan transformer's img_emb. The attention is plain torch
(f32 logits), as the JAX module computes it with einsum.

Parameter names follow the JAX module's with `block_{i}` as `blocks.{i}`:
`patch_embedding.weight` [dim, 3, 14, 14] (no bias), `cls_embedding`
[1, 1, dim], `pos_embedding` [1, 257, dim], LayerNorms `pre_norm`,
`blocks.{i}.norm1` / `norm2` (weight, bias), linears `to_qkv`, `proj`,
`mlp_fc1`, `mlp_fc2`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class WanClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: float = 4.0
    num_heads: int = 16
    num_layers: int = 32  # the forward runs num_layers - 1 (31)
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**kw) -> "WanClipVisionConfig":
        d = dict(image_size=28, patch_size=14, dim=32, num_heads=4, num_layers=2)
        d.update(kw)
        return WanClipVisionConfig(**d)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {"bicubic": _keys_cubic, "linear": _triangle}


def resize_weights(in_size: int, out_size: int, method: str, device=None) -> torch.Tensor:
    """[in_size, out_size] f32 weights of jax.image.resize along one axis
    (scale out/in, no translation, antialiased when downsampling): Keys
    cubic (a = -0.5, "bicubic") or the triangle kernel ("linear"), each output column normalised
    to sum 1, columns sampling outside the input zeroed."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_images(x: torch.Tensor, size, method: str) -> torch.Tensor:
    """x [..., H, W] resized to `size` (h, w) as jax.image.resize resizes
    those two axes (an axis that keeps its size is left alone)."""
    x = x.float()
    h, w = size
    if x.shape[-2] != h:
        x = torch.einsum("...hw,hH->...Hw", x, resize_weights(x.shape[-2], h, method, x.device))
    if x.shape[-1] != w:
        x = torch.einsum("...hw,wW->...hW", x, resize_weights(x.shape[-1], w, method, x.device))
    return x


class _ViTBlock(nn.Module):
    def __init__(self, cfg: WanClipVisionConfig):
        super().__init__()
        self.cfg = cfg
        dim, hidden = cfg.dim, int(cfg.dim * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.to_qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        cfg = self.cfg
        b, s, c = x.shape
        heads = cfg.num_heads
        hd = c // heads
        y = _layer_norm(self.norm1, x).to(cfg.dtype)  # x: the f32 residual stream
        q, k, v = (u.reshape(b, s, heads, hd).transpose(1, 2)
                   for u in self.to_qkv(y).chunk(3, dim=-1))
        logits = (q.float() @ k.float().transpose(-1, -2)) / float(hd) ** 0.5
        o = (torch.softmax(logits, -1).to(v.dtype) @ v).transpose(1, 2).reshape(b, s, c)
        x = x + self.proj(o)
        y = _layer_norm(self.norm2, x).to(cfg.dtype)
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(y), approximate="none"))


def _layer_norm(norm: nn.LayerNorm, x):
    """flax LayerNorm: statistics and affine in f32."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


class WanClipVision(nn.Module):
    def __init__(self, cfg: WanClipVisionConfig):
        super().__init__()
        self.config = cfg
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embedding = nn.Conv2d(3, cfg.dim, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False)
        self.cls_embedding = nn.Parameter(torch.empty(1, 1, cfg.dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, n + 1, cfg.dim))
        self.pre_norm = nn.LayerNorm(cfg.dim, eps=1e-5)
        self.blocks = nn.ModuleList([_ViTBlock(cfg) for _ in range(cfg.num_layers - 1)])
        self.to(cfg.dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded weights (no checkpoint): the class and position
        embeddings normal / sqrt(dim) (the JAX init), the patch embedding
        and linears normal with variance 1/fan_in, biases zero, LayerNorms
        one and zero."""
        def normal_(w, std):
            w.copy_(torch.randn(w.shape, generator=generator, dtype=torch.float32,
                                device=w.device).mul_(std))

        normal_(self.cls_embedding, self.config.dim ** -0.5)
        normal_(self.pos_embedding, self.config.dim ** -0.5)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                normal_(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, 3, H, W] in [-1, 1] -> tokens [B, 1 + P^2, dim] (f32)."""
        cfg = self.config
        b = pixels.shape[0]
        x = resize_images(pixels, (cfg.image_size, cfg.image_size), "bicubic")
        mean = torch.tensor(CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
        std = torch.tensor(CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
        x = (x * 0.5 + 0.5 - mean) / std
        x = self.patch_embedding(x.to(cfg.dtype)).flatten(2).transpose(1, 2)  # [B, n, dim]
        # the class token, the position table and the residual stream in f32
        # (the JAX module's parameters are f32 and promote what they touch)
        x = torch.cat([self.cls_embedding.float().expand(b, 1, cfg.dim), x.float()], dim=1)
        x = _layer_norm(self.pre_norm, x + self.pos_embedding.float())
        for blk in self.blocks:
            x = blk(x)
        return x


def convert_wan_clip_visual(sd: Mapping[str, torch.Tensor],
                            cfg: WanClipVisionConfig) -> Dict[str, torch.Tensor]:
    """The Wan CLIP checkpoint's visual.* keys -> the port's state dict
    (the first num_layers - 1 blocks; torch layouts carry over)."""
    out = {"patch_embedding.weight": sd["visual.patch_embedding.weight"],
           "cls_embedding": sd["visual.cls_embedding"],
           "pos_embedding": sd["visual.pos_embedding"],
           "pre_norm.weight": sd["visual.pre_norm.weight"],
           "pre_norm.bias": sd["visual.pre_norm.bias"]}
    names = {"norm1": "norm1", "to_qkv": "attn.to_qkv", "proj": "attn.proj",
             "norm2": "norm2", "mlp_fc1": "mlp.0", "mlp_fc2": "mlp.2"}
    for i in range(cfg.num_layers - 1):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"blocks.{i}.{ours}.{leaf}"] = sd[f"visual.transformer.{i}.{theirs}.{leaf}"]
    return out
