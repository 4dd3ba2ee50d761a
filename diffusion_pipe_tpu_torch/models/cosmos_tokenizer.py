"""Cosmos-1's continuous video tokenizer (the CV8x8x8 family, factorized).

Counterpart of diffusion_pipe_tpu/models/cosmos_tokenizer.py, channels
first ([B, C, T, H, W]). The reference builds it with patch_size 4 (haar),
channels 128, channels_mult (2, 4, 4), 2 resnets a level, GroupNorm(1), z
16 and embedding 16, 8x in space and time:

- the haar patcher: the first frame replicated patch_size times (causal),
  then log2(patch_size) grouped DWT levels over (t, h, w), each level
  concatenating its 8 subbands band-major and rescaling by 1 / (2 sqrt 2)
  (3 -> 24 -> 192 channels at patch 4); the unpatcher inverts it and drops
  the replicated frames;
- every conv_in / conv_out / resnet conv a factorized pair of causal convs,
  spatial (1, 3, 3) then temporal (3, 1, 1), the time front padded by
  replicating the first frame;
- the hybrid downsample: a strided spatial conv plus a 2 x 2 average pool,
  a strided causal temporal conv plus a 2x average pool, then a 1 x 1 x 1
  mixer; the upsample mirrors it (causal temporal 2x, nearest spatial 2x,
  each with a residual conv);
- the mid blocks: a resnet, spatial attention within each frame, causal
  attention over time at each position, a resnet. The attention is a plain
  product with its softmax in f32, as the other VAEs' mid attention in the
  port (the JAX module's is one plain product too); the spatial one goes a
  few frames at a time, so that its logits stay near 1 GiB (10,560
  positions a frame at 704 x 960: 446 MB of f32 logits each).

encode gives ((z - mean) / std) sigma_data with per-(channel, latent
frame) statistics, decode inverts it. The block internals follow the JAX
module, which follows the public NVIDIA tokenizer modules and is not yet
checked against a released checkpoint. convert_cosmos_tokenizer reads the
topology from the checkpoint's keys and kernel shapes and raises on a key
it does not take; tokenizer_checkpoint writes the port's weights under the
checkpoint's names.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_SQRT2 = 1.4142135623730951
# the checkpoint's buffers that are no weights
_BUFFERS = r"(_arange|wavelets|patch_size_buffer)"


@dataclasses.dataclass(frozen=True)
class CosmosTokenizerConfig:
    in_channels: int = 3
    z_channels: int = 16
    embedding_dim: int = 16
    channels: int = 128
    channels_mult: Tuple[int, ...] = (2, 4, 4)
    num_res_blocks: int = 2
    patch_size: int = 4
    # (spatial down, temporal down) of each level but the last
    downsample_flags: Tuple[Tuple[bool, bool], ...] = ((True, True), (False, False))
    # levels whose resnets are followed by an attention pair
    attn_levels: Tuple[int, ...] = ()
    latent_temporal_chunk: int = 16
    sigma_data: float = 0.5
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**kw) -> "CosmosTokenizerConfig":
        d = dict(channels=8, channels_mult=(1, 2), num_res_blocks=1, patch_size=2,
                 z_channels=4, embedding_dim=4, downsample_flags=((True, True),))
        d.update(kw)
        return CosmosTokenizerConfig(**d)


def _haar_axis(x, dim, high):
    a, b = x.unflatten(dim, (-1, 2)).unbind(dim + 1)
    return (a - b) / _SQRT2 if high else (a + b) / _SQRT2


def haar_patch_3d(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, C 8^levels, (T + p - 1) / 2^levels, ...]: the
    first frame replicated patch_size times, then the grouped DWT levels."""
    levels = int(math.log2(patch_size))
    x = torch.cat([x[:, :, :1].expand(-1, -1, patch_size, -1, -1), x[:, :, 1:]], dim=2)
    for _ in range(levels):
        bands = [_haar_axis(_haar_axis(_haar_axis(x, 2, bt), 3, bh), 4, bw)
                 for bt in (0, 1) for bh in (0, 1) for bw in (0, 1)]
        x = torch.cat(bands, dim=1) / (2.0 * _SQRT2)
    return x


def _ihaar_axis(low, high, dim):
    a, b = (low + high) / _SQRT2, (low - high) / _SQRT2
    return torch.stack([a, b], dim=dim + 1).flatten(dim, dim + 1)


def haar_unpatch_3d(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """The inverse of haar_patch_3d, the replicated first frames dropped."""
    for _ in range(int(math.log2(patch_size))):
        bands = (x * (2.0 * _SQRT2)).chunk(8, dim=1)
        merged = []
        for g in (0, 4):  # the t-low and the t-high group
            hl = _ihaar_axis(bands[g], bands[g + 1], 4)
            hh = _ihaar_axis(bands[g + 2], bands[g + 3], 4)
            merged.append(_ihaar_axis(hl, hh, 3))
        x = _ihaar_axis(merged[0], merged[1], 2)
    return x[:, :, patch_size - 1:]


class CausalConvF(nn.Module):
    """One causal conv: the time front padded by replicating the first frame
    (kt - 1) times, the space zero-padded symmetrically ("same") or by (0,
    1) for a stride-2 conv ("down")."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 spatial_pad: str = "same", dtype=torch.float32):
        super().__init__()
        self.kernel, self.spatial_pad = tuple(kernel), spatial_pad
        self.conv = nn.Conv3d(in_ch, out_ch, self.kernel, stride=stride, dtype=dtype)

    def forward(self, x):
        kt, kh, kw = self.kernel
        if kt > 1:
            x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
        pad = (0, 1, 0, 1) if self.spatial_pad == "down" else (kw // 2, kw // 2, kh // 2, kh // 2)
        if any(pad):
            x = F.pad(x, pad)
        return self.conv(x)


class FactorizedConv(nn.Module):
    """A spatial (1, 3, 3) causal conv, then a temporal (3, 1, 1) one."""

    def __init__(self, in_ch: int, out_ch: int, dtype):
        super().__init__()
        self.s = CausalConvF(in_ch, out_ch, (1, 3, 3), dtype=dtype)
        self.t = CausalConvF(out_ch, out_ch, (3, 1, 1), dtype=dtype)

    def forward(self, x):
        return self.t(self.s(x))


def _norm(ch, dtype):
    return nn.GroupNorm(1, ch, eps=1e-6, dtype=dtype)


class CosmosResnetF(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype):
        super().__init__()
        self.norm1, self.conv1 = _norm(in_ch, dtype), FactorizedConv(in_ch, out_ch, dtype)
        self.norm2, self.conv2 = _norm(out_ch, dtype), FactorizedConv(out_ch, out_ch, dtype)
        if in_ch != out_ch:
            self.nin_shortcut = CausalConvF(in_ch, out_ch, (1, 1, 1), dtype=dtype)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


# the spatial attention's logits per chunk of frames
_ATTN_CHUNK_BYTES = 2 ** 30


class _AttnBase(nn.Module):
    def __init__(self, ch: int, dtype):
        super().__init__()
        self.norm = _norm(ch, dtype)
        for name in ("q", "k", "v", "proj_out"):
            setattr(self, name, CausalConvF(ch, ch, (1, 1, 1), dtype=dtype))

    @staticmethod
    def _attend(q, k, v, causal=False):
        logits = torch.einsum("bqc,bkc->bqk", q, k).float() / np.sqrt(q.shape[-1])
        if causal:
            t = q.shape[1]
            keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
            logits = logits.masked_fill(~keep, float("-inf"))
        return torch.einsum("bqk,bkc->bqc", torch.softmax(logits, -1).to(v.dtype), v)


class CosmosSpatialAttn(_AttnBase):
    """Self-attention within each frame (1 x 1 x 1 conv projections)."""

    def forward(self, x):
        b, c, t, hh, ww = x.shape
        h = self.norm(x)

        def rows(y):  # [B T, H W, C]
            return y.permute(0, 2, 3, 4, 1).reshape(b * t, hh * ww, c)

        q, k, v = rows(self.q(h)), rows(self.k(h)), rows(self.v(h))
        step = max(1, _ATTN_CHUNK_BYTES // (4 * (hh * ww) ** 2))
        o = torch.cat([self._attend(q[i:i + step], k[i:i + step], v[i:i + step])
                       for i in range(0, b * t, step)])
        o = o.reshape(b, t, hh, ww, c).permute(0, 4, 1, 2, 3)
        return x + self.proj_out(o)


class CosmosTemporalAttn(_AttnBase):
    """Causally masked self-attention over time at each position."""

    def forward(self, x):
        b, c, t, hh, ww = x.shape
        h = self.norm(x)

        def rows(y):  # [B H W, T, C]
            return y.permute(0, 3, 4, 2, 1).reshape(b * hh * ww, t, c)

        o = self._attend(rows(self.q(h)), rows(self.k(h)), rows(self.v(h)), causal=True)
        o = o.reshape(b, hh, ww, t, c).permute(0, 4, 3, 1, 2)
        return x + self.proj_out(o)


class CosmosHybridDownsample(nn.Module):
    def __init__(self, ch: int, spatial: bool, temporal: bool, dtype):
        super().__init__()
        self.spatial, self.temporal = spatial, temporal
        if spatial:
            self.conv1 = CausalConvF(ch, ch, (1, 3, 3), stride=(1, 2, 2), spatial_pad="down",
                                     dtype=dtype)
        if temporal:
            self.conv2_conv = nn.Conv3d(ch, ch, (3, 1, 1), stride=(2, 1, 1), dtype=dtype)
        self.conv3 = CausalConvF(ch, ch, (1, 1, 1), dtype=dtype)

    def forward(self, x):
        if self.spatial:
            x = self.conv1(x) + F.avg_pool3d(x, (1, 2, 2), (1, 2, 2))
        if self.temporal:
            if x.shape[2] % 2 != 1:
                raise ValueError(f"a causal video's latent length must be odd, not {x.shape[2]}")
            xp = torch.cat([x[:, :, :1].expand(-1, -1, 2, -1, -1), x], dim=2)
            conv = self.conv2_conv(xp)
            x = conv + F.avg_pool3d(xp, (2, 1, 1), (2, 1, 1))[:, :, :conv.shape[2]]
        return self.conv3(x)


class CosmosHybridUpsample(nn.Module):
    def __init__(self, ch: int, spatial: bool, temporal: bool, dtype):
        super().__init__()
        self.spatial, self.temporal = spatial, temporal
        if temporal:
            self.conv1 = CausalConvF(ch, ch, (3, 1, 1), dtype=dtype)
        if spatial:
            self.conv2 = CausalConvF(ch, ch, (1, 3, 3), dtype=dtype)
        self.conv3 = CausalConvF(ch, ch, (1, 1, 1), dtype=dtype)

    def forward(self, x):
        if self.temporal:
            x = x.repeat_interleave(2, dim=2)[:, :, 1:]  # 1 + k -> 1 + 2k frames
            x = self.conv1(x) + x
        if self.spatial:
            x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
            x = self.conv2(x) + x
        return self.conv3(x)


def _mid(mod: nn.Module, ch: int, dtype):
    mod.mid_res_0 = CosmosResnetF(ch, ch, dtype)
    mod.mid_attn_s = CosmosSpatialAttn(ch, dtype)
    mod.mid_attn_t = CosmosTemporalAttn(ch, dtype)
    mod.mid_res_1 = CosmosResnetF(ch, ch, dtype)


def _run_mid(mod, h):
    return mod.mid_res_1(mod.mid_attn_t(mod.mid_attn_s(mod.mid_res_0(h))))


class CosmosTokenizerEncoder(nn.Module):
    def __init__(self, cfg: CosmosTokenizerConfig):
        super().__init__()
        self.cfg = cfg
        dt, n = cfg.dtype, len(cfg.channels_mult)
        self.conv_in = FactorizedConv(cfg.in_channels * cfg.patch_size ** 3, cfg.channels, dt)
        ch = cfg.channels
        for i, mult in enumerate(cfg.channels_mult):
            for j in range(cfg.num_res_blocks):
                setattr(self, f"down_{i}_res_{j}", CosmosResnetF(ch, cfg.channels * mult, dt))
                ch = cfg.channels * mult
                if i in cfg.attn_levels:
                    setattr(self, f"down_{i}_attn_{j}_s", CosmosSpatialAttn(ch, dt))
                    setattr(self, f"down_{i}_attn_{j}_t", CosmosTemporalAttn(ch, dt))
            if i < n - 1 and any(cfg.downsample_flags[i]):
                setattr(self, f"down_{i}_downsample",
                        CosmosHybridDownsample(ch, *cfg.downsample_flags[i], dt))
        _mid(self, ch, dt)
        self.norm_out = _norm(ch, dt)
        self.conv_out = FactorizedConv(ch, cfg.z_channels, dt)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(haar_patch_3d(x, cfg.patch_size))
        for i in range(len(cfg.channels_mult)):
            for j in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{i}_res_{j}")(h)
                if i in cfg.attn_levels:
                    h = getattr(self, f"down_{i}_attn_{j}_s")(h)
                    h = getattr(self, f"down_{i}_attn_{j}_t")(h)
            if hasattr(self, f"down_{i}_downsample"):
                h = getattr(self, f"down_{i}_downsample")(h)
        return self.conv_out(F.silu(self.norm_out(_run_mid(self, h))))


class CosmosTokenizerDecoder(nn.Module):
    def __init__(self, cfg: CosmosTokenizerConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        ch = cfg.channels * cfg.channels_mult[-1]
        self.conv_in = FactorizedConv(cfg.z_channels, ch, dt)
        _mid(self, ch, dt)
        for i in reversed(range(len(cfg.channels_mult))):
            out = cfg.channels * cfg.channels_mult[i]
            for j in range(cfg.num_res_blocks + 1):
                setattr(self, f"up_{i}_res_{j}", CosmosResnetF(ch, out, dt))
                ch = out
                if i in cfg.attn_levels:
                    setattr(self, f"up_{i}_attn_{j}_s", CosmosSpatialAttn(ch, dt))
                    setattr(self, f"up_{i}_attn_{j}_t", CosmosTemporalAttn(ch, dt))
            if i > 0 and any(cfg.downsample_flags[i - 1]):
                setattr(self, f"up_{i}_upsample",
                        CosmosHybridUpsample(ch, *cfg.downsample_flags[i - 1], dt))
        self.norm_out = _norm(ch, dt)
        self.conv_out = FactorizedConv(ch, cfg.in_channels * cfg.patch_size ** 3, dt)

    def forward(self, z):
        cfg = self.cfg
        h = _run_mid(self, self.conv_in(z))
        for i in reversed(range(len(cfg.channels_mult))):
            for j in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
                if i in cfg.attn_levels:
                    h = getattr(self, f"up_{i}_attn_{j}_s")(h)
                    h = getattr(self, f"up_{i}_attn_{j}_t")(h)
            if hasattr(self, f"up_{i}_upsample"):
                h = getattr(self, f"up_{i}_upsample")(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return haar_unpatch_3d(h, cfg.patch_size)


class CosmosVideoTokenizer(nn.Module):
    """encode [B, 3, F, H, W] -> sigma_data-scaled latents, decode back."""

    def __init__(self, cfg: CosmosTokenizerConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = CosmosTokenizerEncoder(cfg)
        self.decoder = CosmosTokenizerDecoder(cfg)
        self.quant_conv = CausalConvF(cfg.z_channels, cfg.embedding_dim, (1, 1, 1), dtype=cfg.dtype)
        self.post_quant_conv = CausalConvF(cfg.embedding_dim, cfg.z_channels, (1, 1, 1),
                                           dtype=cfg.dtype)
        k = cfg.embedding_dim * cfg.latent_temporal_chunk
        self.register_buffer("latent_mean", torch.zeros(k, dtype=torch.float32))
        self.register_buffer("latent_std", torch.ones(k, dtype=torch.float32))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded weights: every conv normal of std 1 / sqrt(fan_in) with a
        zero bias, the norms at 1 and 0, the statistics at 0 and 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                tmp = torch.empty(m.weight.shape, dtype=torch.float32, device=m.weight.device)
                m.weight.copy_(tmp.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator))
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.latent_mean.zero_()
        self.latent_std.fill_(1.0)

    def _stats(self, t: int, dtype):
        e = self.cfg.embedding_dim
        shape = (1, e, t, 1, 1)
        return (self.latent_mean.reshape(e, -1)[:, :t].reshape(shape).to(dtype),
                self.latent_std.reshape(e, -1)[:, :t].reshape(shape).to(dtype))

    def encode(self, pixels: torch.Tensor) -> torch.Tensor:
        z = self.quant_conv(self.encoder(pixels.to(self.cfg.dtype)))
        mean, std = self._stats(z.shape[2], z.dtype)
        return (z - mean) / std * self.cfg.sigma_data

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        mean, std = self._stats(latents.shape[2], self.cfg.dtype)
        z = latents.to(self.cfg.dtype) / self.cfg.sigma_data * std + mean
        return self.decoder(self.post_quant_conv(z))

    def forward(self, pixels):
        return self.decode(self.encode(pixels))


# --- the checkpoint's names ----------------------------------------------------

# port module path part -> the checkpoint's, applied in order to a state-dict key
_RENAMES = (
    (r"\b(down|up)_(\d+)_res_(\d+)\b", r"\1.\2.block.\3"),
    (r"\b(down|up)_(\d+)_attn_(\d+)_s\b", r"\1.\2.attn.\3.0"),
    (r"\b(down|up)_(\d+)_attn_(\d+)_t\b", r"\1.\2.attn.\3.1"),
    (r"\b(down|up)_(\d+)_(downsample|upsample)\b", r"\1.\2.\3"),
    (r"\bmid_res_0\b", "mid.block_1"), (r"\bmid_res_1\b", "mid.block_2"),
    (r"\bmid_attn_s\b", "mid.attn_1.0"), (r"\bmid_attn_t\b", "mid.attn_1.1"),
    (r"\.s\.conv\.", ".0.conv3d."), (r"\.t\.conv\.", ".1.conv3d."),
    (r"\.conv2_conv\.", ".conv2.conv3d."), (r"\.conv\.", ".conv3d."),
    (r"\.(norm|norm1|norm2|norm_out)\.(weight|bias)$", r".\1.norm.\2"),
)


def checkpoint_name(key: str) -> str:
    """The checkpoint's name (the `.conv3d` / `.norm` wrapped dialect) of a
    port state-dict key."""
    for pat, rep in _RENAMES:
        key = re.sub(pat, rep, key)
    return key


def _bare(name: str) -> str:
    """The other dialect: a bare Conv3d / GroupNorm without the wrapper."""
    return name.replace(".conv3d.", ".").replace(".norm.weight", ".weight").replace(
        ".norm.bias", ".bias")


def tokenizer_layout(sd: Mapping[str, torch.Tensor]) -> CosmosTokenizerConfig:
    """The topology a checkpoint's keys and kernel shapes give: the levels
    and resnets (encoder.down.N.block.M), the channels (conv_in's outputs),
    the patch size (8x channels a haar level), the multipliers, which
    hybrid down / upsample convs exist, the attention levels, z and
    embedding widths and the statistics' chunk."""
    def cw(key):
        for k in (f"{key}.conv3d.weight", f"{key}.weight"):
            if k in sd:
                return sd[k]
        return None

    def indices(pattern):
        return sorted({int(m.group(1)) for k in sd for m in [re.match(pattern, k)] if m})

    levels = indices(r"encoder\.down\.(\d+)\.")
    if levels != list(range(len(levels))) or not levels:
        raise KeyError(f"encoder levels {levels} are not 0..n-1")
    n = len(levels)
    conv_in = cw("encoder.conv_in.0")
    if conv_in is None:
        raise KeyError("the checkpoint lacks encoder.conv_in.0, which its layout is read from")
    channels, c, haar = conv_in.shape[0], conv_in.shape[1], 0
    while c % 8 == 0 and c > 1:  # a haar level multiplies the channels by 8
        c, haar = c // 8, haar + 1
        if c in (1, 3):
            break
    flags = tuple((cw(f"encoder.down.{i}.downsample.conv1") is not None,
                   cw(f"encoder.down.{i}.downsample.conv2") is not None) for i in range(n - 1))
    emb = cw("quant_conv").shape[0]
    return CosmosTokenizerConfig(
        in_channels=c, channels=channels,
        channels_mult=tuple(cw(f"encoder.down.{i}.block.0.conv1.0").shape[0] // channels
                            for i in range(n)),
        num_res_blocks=len(indices(r"encoder\.down\.0\.block\.(\d+)\.")),
        patch_size=2 ** haar, z_channels=cw("encoder.conv_out.0").shape[0],
        embedding_dim=emb, downsample_flags=flags,
        attn_levels=tuple(i for i in range(n) if cw(f"encoder.down.{i}.attn.0.0.q") is not None),
        latent_temporal_chunk=sd["latent_mean"].numel() // emb)


def convert_cosmos_tokenizer(sd: Mapping[str, torch.Tensor], dtype=torch.float32
                             ) -> Tuple[CosmosTokenizerConfig, Dict[str, torch.Tensor]]:
    """An NVIDIA continuous-tokenizer checkpoint (encoder.*, decoder.*,
    quant_conv, post_quant_conv, latent_mean / latent_std; each conv bare or
    wrapped as `.conv3d`, each GroupNorm bare or as `.norm`) -> (config,
    the port's state dict). A decoder upsample's temporal and spatial convs
    are told apart by their kernel shapes, not their names. A key the model
    needs and the checkpoint lacks, or a checkpoint key that no weight
    takes (but the haar buffers), raises KeyError naming it."""
    from .weights import TrackedDict

    cfg = dataclasses.replace(tokenizer_layout(sd), dtype=dtype)
    with torch.device("meta"):
        model = CosmosVideoTokenizer(cfg)
    src = TrackedDict(sd, "the Cosmos tokenizer checkpoint")
    out = {}
    for key, p in model.state_dict().items():
        name = checkpoint_name(key)
        m = re.match(r"(decoder\.up\.\d+\.upsample)\.(conv1|conv2)\.conv3d\.(weight|bias)$", name)
        if m:  # find the conv of this role (temporal conv1, spatial conv2) by its kernel
            base, role, leaf = m.groups()
            temporal = role == "conv1"
            for cand in ("conv1", "conv2"):
                w = next((sd[k] for k in (f"{base}.{cand}.conv3d.weight", f"{base}.{cand}.weight")
                          if k in sd), None)
                if w is not None and (w.shape[2] == 3) == temporal:
                    name = f"{base}.{cand}.conv3d.{leaf}"
        if name not in sd:
            name = _bare(name)
        out[key] = src[name].reshape(p.shape)
    src.check_all_read((_BUFFERS,))
    return cfg, out


def tokenizer_checkpoint(model: CosmosVideoTokenizer) -> Dict[str, torch.Tensor]:
    """The model's weights under the checkpoint's names (the wrapped
    dialect), on the CPU: what convert_cosmos_tokenizer reads back."""
    return {checkpoint_name(k): v.detach().contiguous().cpu()
            for k, v in model.state_dict().items()}
