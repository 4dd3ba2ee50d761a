"""Wan 2.2 (ti2v-5B) video VAE as a PyTorch module.

Counterpart of diffusion_pipe_tpu/models/wan_vae22.py, built from the 2.1
VAE's parts (models/wan_vae.py), with its differences:
- the video is 2x2-patchified to 12 channels before the encoder and
  unpatchified after the decoder (patchify2 / unpatchify2);
- every stage is a residual macro block: the convolution path plus a
  parameter-free AvgDown3D / DupUp3D shortcut (avg_down3d / dup_up3d);
- the upsampling convolution keeps the channel width;
- separate encoder and decoder widths (dim 160, dec_dim 256), z_dim 48 and
  its own latent mean/std;
- the decoder's first chunk drops the duplicated leading frames.
Chunking (1 + 4k frames; one latent frame per decoder chunk) and the Cache
threading are the 2.1 VAE's. Layout [B, C, T, H, W].

Module names follow the JAX module's: `down_{i}_res_{j}`,
`down_{i}_spatial`, `down_{i}_time`, `up_{i}_res_{j}`, `up_{i}_time`,
`up_{i}_spatial`, `mid_res_0`, `mid_attn`, `mid_res_1`, `head_norm`,
`head_conv`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .wan_vae import (AttentionBlock2d, CausalConv3d, RMSNormSpatial, ResidualBlock3d,
                      SpatialDown, SpatialUp, TimeDown, TimeUp, WanVideoVAE)
from .wan_vae_convert import convert_layout, load_vae_checkpoint

WAN22_LATENT_MEAN = [
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.157, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.123,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.052, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667,
]
WAN22_LATENT_STD = [
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.499, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.06, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744,
]


@dataclasses.dataclass(frozen=True)
class Wan22VAEConfig:
    dim: int = 160
    dec_dim: int = 256
    z_dim: int = 48
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    dtype: torch.dtype = torch.float32

    @staticmethod
    def ti2v_5b(**kw) -> "Wan22VAEConfig":
        return Wan22VAEConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "Wan22VAEConfig":
        # the last two mults must be equal: the final stage's parameter-free
        # AvgDown3D shortcut cannot change the channel count (factor 1)
        d = dict(dim=8, dec_dim=8, z_dim=8, dim_mult=(2, 2), num_res_blocks=1,
                 temperal_downsample=(True,))
        d.update(kw)
        return Wan22VAEConfig(**d)


def patchify2(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, 2h, 2w] -> [B, 4C, T, h, w], channel c*4 + r*2 + q with q
    the H factor and r the W factor (the JAX channel order)."""
    b, c, t, hp, wp = x.shape
    x = x.reshape(b, c, t, hp // 2, 2, wp // 2, 2)   # [B, C, T, h, q, w, r]
    x = x.permute(0, 1, 6, 4, 2, 3, 5)                # [B, C, r, q, T, h, w]
    return x.reshape(b, c * 4, t, hp // 2, wp // 2)


def unpatchify2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of patchify2."""
    b, c4, t, h, w = x.shape
    x = x.reshape(b, c4 // 4, 2, 2, t, h, w)          # [B, C, r, q, T, h, w]
    x = x.permute(0, 1, 4, 5, 3, 6, 2)                # [B, C, T, h, q, w, r]
    return x.reshape(b, c4 // 4, t, h * 2, w * 2)


def avg_down3d(x: torch.Tensor, out_channels: int, factor_t: int, factor_s: int) -> torch.Tensor:
    """AvgDown3D: the (ft, fs, fs) neighbourhoods folded into channels in
    the order (C, ft, fs_h, fs_w), then averaged in groups down to
    out_channels; time padded at the front to a multiple of ft."""
    ft, fs = factor_t, factor_s
    b, c, t, h, w = x.shape
    pad_t = (ft - t % ft) % ft
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        t += pad_t
    x = x.reshape(b, c, t // ft, ft, h // fs, fs, w // fs, fs)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    x = x.reshape(b, out_channels, (c * ft * fs * fs) // out_channels, t // ft, h // fs, w // fs)
    return x.mean(dim=2)


def dup_up3d(x: torch.Tensor, out_channels: int, factor_t: int, factor_s: int,
             first_chunk: bool) -> torch.Tensor:
    """DupUp3D: each channel repeated, the copies unfolded into (ft, fs, fs)
    neighbourhoods; the first chunk keeps its last ft frames' last one."""
    ft, fs = factor_t, factor_s
    b, c, t, h, w = x.shape
    x = x.repeat_interleave(out_channels * ft * fs * fs // c, dim=1)
    x = x.reshape(b, out_channels, ft, fs, fs, t, h, w)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(b, out_channels, t * ft, h * fs, w * fs)
    return x[:, :, ft - 1:] if first_chunk else x


class Encoder22(nn.Module):
    def __init__(self, cfg: Wan22VAEConfig):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.dims = dims
        self.conv1 = CausalConv3d(12, dims[0])
        n = len(cfg.dim_mult)
        for i in range(n):
            ch = dims[i]
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{i}_res_{j}", ResidualBlock3d(ch, dims[i + 1]))
                ch = dims[i + 1]
            if i != n - 1:
                self.add_module(f"down_{i}_spatial", SpatialDown(ch))
                if self._t_down(i):
                    self.add_module(f"down_{i}_time", TimeDown(ch))
        ch = dims[-1]
        self.mid_res_0 = ResidualBlock3d(ch, ch)
        self.mid_attn = AttentionBlock2d(ch)
        self.mid_res_1 = ResidualBlock3d(ch, ch)
        self.head_norm = RMSNormSpatial(ch)
        self.head_conv = CausalConv3d(ch, 2 * cfg.z_dim)

    def _t_down(self, i):
        td = self.cfg.temperal_downsample
        return td[i] if i < len(td) else False

    def forward(self, x, cache):
        cfg = self.cfg
        n = len(cfg.dim_mult)
        h = self.conv1(x, cache)
        for i in range(n):
            t_down, down = self._t_down(i), i != n - 1
            shortcut = avg_down3d(h, self.dims[i + 1], factor_t=2 if t_down else 1,
                                  factor_s=2 if down else 1)
            y = h
            for j in range(cfg.num_res_blocks):
                y = getattr(self, f"down_{i}_res_{j}")(y, cache)
            if down:
                y = getattr(self, f"down_{i}_spatial")(y)
                if t_down:
                    y = getattr(self, f"down_{i}_time")(y, cache)
            h = y + shortcut
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, cache)), cache)
        return self.head_conv(F.silu(self.head_norm(h)), cache)


class Decoder22(nn.Module):
    def __init__(self, cfg: Wan22VAEConfig):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.dec_dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
        self.dims = dims
        ch = dims[0]
        self.conv1 = CausalConv3d(cfg.z_dim, ch)
        self.mid_res_0 = ResidualBlock3d(ch, ch)
        self.mid_attn = AttentionBlock2d(ch)
        self.mid_res_1 = ResidualBlock3d(ch, ch)
        n = len(cfg.dim_mult)
        for i in range(n):
            ch = dims[i]
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i}_res_{j}", ResidualBlock3d(ch, dims[i + 1]))
                ch = dims[i + 1]
            if i != n - 1:
                if self._t_up(i):
                    self.add_module(f"up_{i}_time", TimeUp(ch))
                self.add_module(f"up_{i}_spatial", SpatialUp(ch, ch))
        self.head_norm = RMSNormSpatial(dims[-1])
        self.head_conv = CausalConv3d(dims[-1], 12)

    def _t_up(self, i):
        tu = tuple(reversed(self.cfg.temperal_downsample))
        return tu[i] if i < len(tu) else False

    def forward(self, z, cache, first_chunk: bool = False):
        cfg = self.cfg
        n = len(cfg.dim_mult)
        h = self.conv1(z, cache)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, cache)), cache)
        for i in range(n):
            t_up, up = self._t_up(i), i != n - 1
            y = h
            for j in range(cfg.num_res_blocks + 1):
                y = getattr(self, f"up_{i}_res_{j}")(y, cache)
            if up:
                if t_up:
                    y = getattr(self, f"up_{i}_time")(y, cache)
                y = getattr(self, f"up_{i}_spatial")(y)
                h = y + dup_up3d(h, self.dims[i + 1], factor_t=2 if t_up else 1, factor_s=2,
                                 first_chunk=first_chunk)
            else:
                h = y
        return self.head_conv(F.silu(self.head_norm(h)), cache)


class WanVideoVAE22(WanVideoVAE):
    """The ti2v VAE: 16 x 16 x 4 compression to z_dim latent channels;
    encode / decode as the 2.1 VAE's around patchify2 / unpatchify2."""

    latent_mean = WAN22_LATENT_MEAN
    latent_std = WAN22_LATENT_STD
    first_chunk_kw = {"first_chunk": True}

    def __init__(self, cfg: Wan22VAEConfig):
        nn.Module.__init__(self)
        self.config = cfg
        self.encoder = Encoder22(cfg)
        self.conv1_quant = CausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, kernel=(1, 1, 1))
        self.decoder = Decoder22(cfg)
        self.post_quant_conv = CausalConv3d(cfg.z_dim, cfg.z_dim, kernel=(1, 1, 1))
        self.to(cfg.dtype)

    def checkpoint_layout(self):
        return _layout22(self.config)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        return super().encode(patchify2(video.to(self.config.dtype)))

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return unpatchify2(super().decode(latents))


def _layout22(cfg: Wan22VAEConfig):
    """(kind, reference prefix, port prefix) of every module with weights:
    Down_ResidualBlock.downsamples = [res] * num_res_blocks + [Resample],
    Up_ResidualBlock.upsamples = [res] * (num_res_blocks + 1) + [Resample]."""
    for part in ("encoder", "decoder"):
        yield "conv", f"{part}.conv1", f"{part}.conv1.conv"
        yield "res", f"{part}.middle.0", f"{part}.mid_res_0"
        yield "attn", f"{part}.middle.1", f"{part}.mid_attn"
        yield "res", f"{part}.middle.2", f"{part}.mid_res_1"
        yield "rms", f"{part}.head.0", f"{part}.head_norm"
        yield "conv", f"{part}.head.2", f"{part}.head_conv.conv"
    n = len(cfg.dim_mult)
    td = cfg.temperal_downsample
    tu = tuple(reversed(td))
    for i in range(n):
        base = f"encoder.downsamples.{i}.downsamples"
        for j in range(cfg.num_res_blocks):
            yield "res", f"{base}.{j}", f"encoder.down_{i}_res_{j}"
        if i != n - 1:
            r = f"{base}.{cfg.num_res_blocks}"
            yield "conv", f"{r}.resample.1", f"encoder.down_{i}_spatial.conv"
            if i < len(td) and td[i]:
                yield "conv", f"{r}.time_conv", f"encoder.down_{i}_time.time_conv"
    for i in range(n):
        base = f"decoder.upsamples.{i}.upsamples"
        for j in range(cfg.num_res_blocks + 1):
            yield "res", f"{base}.{j}", f"decoder.up_{i}_res_{j}"
        if i != n - 1:
            r = f"{base}.{cfg.num_res_blocks + 1}"
            yield "conv", f"{r}.resample.1", f"decoder.up_{i}_spatial.conv"
            if i < len(tu) and tu[i]:
                yield "conv", f"{r}.time_conv", f"decoder.up_{i}_time.time_conv"
    yield "conv", "conv1", "conv1_quant.conv"
    yield "conv", "conv2", "post_quant_conv.conv"


def convert_wan22_vae(sd: Mapping[str, torch.Tensor], cfg: Wan22VAEConfig
                      ) -> Dict[str, torch.Tensor]:
    """The official Wan2.2 VAE checkpoint (a `vae.` prefix stripped) -> the
    port's state dict."""
    return convert_layout(sd, _layout22(cfg))


def load_wan22_vae(path, dtype: torch.dtype = torch.float32, device=None) -> WanVideoVAE22:
    """The Wan2.2 (ti2v) VAE from a .pth / .pt / .bin or safetensors
    checkpoint, in `dtype` on `device` (default the CPU), frozen."""
    from .weights import load_state_dict_any

    cfg = Wan22VAEConfig.ti2v_5b(dtype=dtype)
    sd = convert_wan22_vae(load_state_dict_any(Path(path)), cfg)
    return load_vae_checkpoint(WanVideoVAE22, cfg, sd, device)
