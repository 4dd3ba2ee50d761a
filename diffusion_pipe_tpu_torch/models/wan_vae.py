"""Wan 2.1 causal video VAE (encoder and decoder) as a PyTorch module.

Counterpart of diffusion_pipe_tpu/models/wan_vae.py: causal 3-D convolutions
with a two-frame temporal left context, RMS-normalised residual blocks,
single-head spatial attention at the bottleneck, temporal downsampling by
stride-2 time convolutions and upsampling by channel-doubling ones, and the
1 + 4k chunking of encode/decode. The chunk recurrence is the model's math
(one pass over the whole clip downsamples time differently), so each
causal convolution's feature cache is explicit state (`Cache`) threaded
through the chunk calls in the JAX package's order.

Layout: torch's [B, C, T, H, W] with F.conv3d / F.conv2d; the JAX module's
is [B, T, H, W, C] (interop.tree_to_state_dict transposes its kernels). The
bottleneck attention is plain torch (matmul and softmax), as the JAX module
computes it with einsum.

Module names follow the JAX module's (`down_{i}`, `down_{i}_s` / `_t`,
`up_{i}`, `up_{i}_t` / `_s`, `mid_res_0`, `mid_attn`, `head_norm`, ...):
a CausalConv3d holds `conv` (nn.Conv3d), a spatial resample `conv`
(nn.Conv2d), a time resample `time_conv`, an RMS norm `gamma` [C].
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

CACHE_T = 2

WAN21_LATENT_MEAN = [
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
]
WAN21_LATENT_STD = [
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
]


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (True, True, False)
    dtype: torch.dtype = torch.float32

    @staticmethod
    def wan21(**kw) -> "WanVAEConfig":
        return WanVAEConfig(**kw)


class Cache:
    """The per-convolution feature caches of one encode or decode, in call
    order: the first chunk (init_mode) appends each convolution's entry,
    later chunks read and replace them from idx 0. An entry is a tensor
    [B, C, <=2, H, W] of the frames before the chunk, None (a temporal
    downsample before its first frame) or the "Rep" sentinel of a temporal
    upsample that has not doubled yet."""

    def __init__(self):
        self.values: List = []
        self.idx = 0
        self.init_mode = True

    def next(self, default=None):
        if self.init_mode:
            self.values.append(default)
            self.idx += 1
            return default
        v = self.values[self.idx]
        self.idx += 1
        return v

    def update(self, value):
        self.values[self.idx - 1] = value


class CausalConv3d(nn.Module):
    """A (3, 3, 3) (or (1, 1, 1)) convolution, causal in time: the two
    frames before the chunk come from the cache (zeros at the start)."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(3, 3, 3), stride=(1, 1, 1)):
        super().__init__()
        self.kernel = tuple(kernel)
        self.conv = nn.Conv3d(in_ch, out_ch, self.kernel, stride,
                              padding=(0, self.kernel[1] // 2, self.kernel[2] // 2))

    def forward(self, x, cache: Optional[Cache]):
        time_pad = 2 * (self.kernel[0] // 2)
        if time_pad > 0:
            if cache is not None:
                b, c, _, h, w = x.shape
                x = torch.cat([cache.next(x.new_zeros((b, c, CACHE_T, h, w))), x], dim=2)
                cache.update(x[:, :, -CACHE_T:])
            else:
                x = F.pad(x, (0, 0, 0, 0, time_pad, 0))
        return self.conv(x)


class RMSNormSpatial(nn.Module):
    """x / ||x||_C * sqrt(C) * gamma over the channel axis, in f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        norm = xf * torch.rsqrt(xf.pow(2).sum(1, keepdim=True) + 1e-12)
        g = self.gamma.float().reshape((1, -1) + (1,) * (x.dim() - 2))
        return (norm * (x.shape[1] ** 0.5) * g).to(x.dtype)


class ResidualBlock3d(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm1 = RMSNormSpatial(in_dim)
        self.conv1 = CausalConv3d(in_dim, out_dim)
        self.norm2 = RMSNormSpatial(out_dim)
        self.conv2 = CausalConv3d(out_dim, out_dim)
        self.shortcut = (CausalConv3d(in_dim, out_dim, kernel=(1, 1, 1))
                         if in_dim != out_dim else None)

    def forward(self, x, cache: Optional[Cache]):
        h = self.conv1(F.silu(self.norm1(x)), cache)
        h = self.conv2(F.silu(self.norm2(h)), cache)
        if self.shortcut is not None:
            x = self.shortcut(x, None)
        return x + h


class AttentionBlock2d(nn.Module):
    """Single-head spatial attention within each frame."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = RMSNormSpatial(dim)
        self.to_qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, c, t, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
        q, k, v = self.to_qkv(y).chunk(3, dim=-1)
        attn = torch.softmax((q @ k.transpose(1, 2)) / torch.tensor(float(c) ** 0.5,
                                                                     dtype=q.dtype), -1)
        y = self.proj(attn @ v)
        return x + y.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


def _per_frame(x, fn):
    """fn over [B*T, C, H, W] frames of x [B, C, T, H, W]."""
    b, c, t, h, w = x.shape
    y = fn(x.transpose(1, 2).reshape(b * t, c, h, w))
    return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


class SpatialDown(nn.Module):
    """Pad right and bottom by one, then a stride-2 3x3 convolution."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, stride=2)

    def forward(self, x):
        return _per_frame(x, lambda y: self.conv(F.pad(y, (0, 1, 0, 1))))


class TimeDown(nn.Module):
    """A stride-2 (3, 1, 1) time convolution over the chunk and the last
    frame before it; the first (one-frame) chunk passes through."""

    def __init__(self, dim: int):
        super().__init__()
        self.time_conv = nn.Conv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1))

    def forward(self, x, cache: Cache):
        prev = cache.next(None)
        if prev is None:
            cache.update(x)
            return x
        y = self.time_conv(torch.cat([prev[:, :, -1:], x], dim=2))
        cache.update(x[:, :, -1:])
        return y


class TimeUp(nn.Module):
    """A channel-doubling causal (3, 1, 1) time convolution whose halves
    become consecutive frames. The first chunk passes through (the "Rep"
    sentinel); the second sees zero left context; later ones the cache."""

    def __init__(self, dim: int):
        super().__init__()
        self.time_conv = nn.Conv3d(dim, 2 * dim, (3, 1, 1))

    def forward(self, x, cache: Cache):
        b, c, t, h, w = x.shape

        def doubled(y):  # [B, 2C, T, H, W] -> [B, C, 2T, H, W]
            y = y.reshape(b, 2, c, -1, h, w).permute(0, 2, 3, 1, 4, 5)
            return y.reshape(b, c, -1, h, w)

        prev = cache.next("Rep")
        if isinstance(prev, str):
            if cache.init_mode:
                return x
            y = self.time_conv(F.pad(x, (0, 0, 0, 0, 2, 0)))
            zx = torch.cat([torch.zeros_like(x[:, :, -1:]), x], dim=2)
            cache.update(zx[:, :, -CACHE_T:])
            return doubled(y)
        full = torch.cat([prev, x], dim=2)
        cache.update(full[:, :, -CACHE_T:])
        return doubled(self.time_conv(full))


class SpatialUp(nn.Module):
    """Nearest 2x upsample, then a 3x3 convolution to out_dim channels."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, out_dim, 3, padding=1)

    def forward(self, x):
        return _per_frame(x, lambda y: self.conv(
            F.interpolate(y, scale_factor=2.0, mode="nearest")))


class Encoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv1 = CausalConv3d(3, dims[0])
        self.order: List[str] = []  # the down path's module names, in call order
        li, scale, ch = 0, 1.0, dims[0]
        for i, out_dim in enumerate(dims[1:]):
            for _ in range(cfg.num_res_blocks):
                self._add(f"down_{li}", ResidualBlock3d(ch, out_dim))
                ch = out_dim
                li += 1
                if scale in cfg.attn_scales:
                    self._add(f"down_{li}", AttentionBlock2d(ch))
                    li += 1
            if i != len(cfg.dim_mult) - 1:
                self._add(f"down_{li}_s", SpatialDown(ch))
                if cfg.temperal_downsample[i]:
                    self._add(f"down_{li}_t", TimeDown(ch))
                li += 1
                scale /= 2.0
        self.mid_res_0 = ResidualBlock3d(ch, ch)
        self.mid_attn = AttentionBlock2d(ch)
        self.mid_res_1 = ResidualBlock3d(ch, ch)
        self.head_norm = RMSNormSpatial(ch)
        self.head_conv = CausalConv3d(ch, 2 * cfg.z_dim)

    def _add(self, name, module):
        self.add_module(name, module)
        self.order.append(name)

    def forward(self, x, cache: Cache):
        h = self.conv1(x, cache)
        for name in self.order:
            h = _call(getattr(self, name), h, cache)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, cache)), cache)
        return self.head_conv(F.silu(self.head_norm(h)), cache)


class Decoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
        temperal_upsample = tuple(reversed(cfg.temperal_downsample))
        ch = dims[0]
        self.conv1 = CausalConv3d(cfg.z_dim, ch)
        self.mid_res_0 = ResidualBlock3d(ch, ch)
        self.mid_attn = AttentionBlock2d(ch)
        self.mid_res_1 = ResidualBlock3d(ch, ch)
        self.order: List[str] = []
        li = 0
        for i, out_dim in enumerate(dims[1:]):
            for _ in range(cfg.num_res_blocks + 1):
                self._add(f"up_{li}", ResidualBlock3d(ch, out_dim))
                ch = out_dim
                li += 1
            if i != len(cfg.dim_mult) - 1:
                if temperal_upsample[i]:
                    self._add(f"up_{li}_t", TimeUp(ch))
                self._add(f"up_{li}_s", SpatialUp(ch, ch // 2))
                ch //= 2
                li += 1
        self.head_norm = RMSNormSpatial(ch)
        self.head_conv = CausalConv3d(ch, 3)

    _add = Encoder3d._add

    def forward(self, z, cache: Cache):
        h = self.conv1(z, cache)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, cache)), cache)
        for name in self.order:
            h = _call(getattr(self, name), h, cache)
        return self.head_conv(F.silu(self.head_norm(h)), cache)


def _call(module, h, cache):
    """A path module with its cache, or without one (attention, spatial
    resamples)."""
    if isinstance(module, (ResidualBlock3d, TimeDown, TimeUp)):
        return module(h, cache)
    return module(h)


def encode_chunks(encoder: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The encoder over x [B, C, 1 + 4k, H, W] in chunks of 1, 4, 4, ...
    frames, one Cache threaded through them."""
    n_chunks = 1 + (x.shape[2] - 1) // 4
    cache = Cache()
    outs = [encoder(x[:, :, :1], cache)]
    cache.init_mode = False
    for i in range(n_chunks - 1):
        cache.idx = 0
        outs.append(encoder(x[:, :, 1 + 4 * i:1 + 4 * (i + 1)], cache))
    return torch.cat(outs, dim=2)


def decode_chunks(decoder: nn.Module, z: torch.Tensor, **first_kw) -> torch.Tensor:
    """The decoder over z [B, z, T', H', W'] one latent frame at a time,
    one Cache threaded through them; first_kw go to the first call only."""
    cache = Cache()
    outs = [decoder(z[:, :, :1], cache, **first_kw)]
    cache.init_mode = False
    for i in range(1, z.shape[2]):
        cache.idx = 0
        outs.append(decoder(z[:, :, i:i + 1], cache))
    return torch.cat(outs, dim=2)


def _stats(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device).reshape(1, -1, 1, 1, 1)


class WanVideoVAE(nn.Module):
    """encode(video [B, 3, 1 + 4k, H, W] in [-1, 1]) -> latents
    [B, z, 1 + k, H/8, W/8], normalised (mu - mean) / std; decode inverts
    it to video in [-1, 1]. Parameters and compute in cfg.dtype."""

    latent_mean = WAN21_LATENT_MEAN
    latent_std = WAN21_LATENT_STD
    first_chunk_kw: dict = {}  # the decoder's arguments on the first chunk

    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder3d(cfg)
        self.conv1_quant = CausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, kernel=(1, 1, 1))
        self.decoder = Decoder3d(cfg)
        self.post_quant_conv = CausalConv3d(cfg.z_dim, cfg.z_dim, kernel=(1, 1, 1))
        self.to(cfg.dtype)

    def _normalized(self) -> bool:
        """The latent statistics apply at their own width only (a tiny
        test config has none)."""
        return len(self.latent_mean) == self.config.z_dim

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        x = video.to(self.config.dtype)
        moments = self.conv1_quant(encode_chunks(self.encoder, x), None)
        mu = moments[:, :self.config.z_dim]
        if self._normalized():
            mu = (mu - _stats(self.latent_mean, mu)) / _stats(self.latent_std, mu)
        return mu

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        z = latents.to(self.config.dtype)
        if self._normalized():
            z = z * _stats(self.latent_std, z) + _stats(self.latent_mean, z)
        x = decode_chunks(self.decoder, self.post_quant_conv(z, None), **self.first_chunk_kw)
        return x.clamp(-1.0, 1.0)

    def checkpoint_layout(self):
        """(kind, reference prefix, port prefix) of every module with
        weights in the reference checkpoint (models/wan_vae_convert.py)."""
        from .wan_vae_convert import _layout

        return _layout(self.config)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded weights (no checkpoint): each convolution and linear
        normal with variance 1/fan_in (drawn in f32, then cast), biases
        zero, RMS scales one."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                w = m.weight
                tmp = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                                  device=w.device)
                w.copy_(tmp.mul_(w[0].numel() ** -0.5))
                m.bias.zero_()
            elif isinstance(m, RMSNormSpatial):
                m.gamma.fill_(1.0)
