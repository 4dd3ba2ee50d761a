"""LTX-Video causal VAE (Lightricks' CausalVideoAutoencoder) as a PyTorch module.

Counterpart of diffusion_pipe_tpu/models/ltx_vae.py. A 4 x 4 patchify in
front of causal 3D convolutions, pixel-RMS resnets (each pixel's channels
normalised, no affine, eps 1e-8), stride-(2, 2, 2) compressions, 128 latent
channels normalised by per-channel statistics: 32x in space, 8x in time (F
= 8 (Fl - 1) + 1 frames). Training needs the encoder and the statistics.

The causal convolutions repeat the first frame k - 1 times in front and
pad space with zeros (Lightricks' CausalConv3d, nn.Conv3d's padding; the
HunyuanVideo VAE replicates space instead). The encoder is the published
one, where the JAX module departs from it in three ways (ROADMAP C):
- D4, the patch order: Lightricks' rearrange "b c (f p) (h q) (w r) -> b (c
  p r q) f h w" orders the patch channels (c, pw, ph), c slowest and the
  width offset before the height offset (diffusers' permute (0, 1, 3, 7, 5,
  2, 4, 6)); the JAX _patchify orders them (ph, pw, c);
- D5, the log-variance: conv_out emits latent + 1 channels, the last one the
  log-variance of every latent channel (latent_log_var "uniform"); the JAX
  module expects 2 x latent, and its converter reads a real checkpoint's
  129 rows as 64 latent channels;
- D6, the channel-change resnet's shortcut: an affine LayerNorm over the
  input channels (eps 1e-6, `norm3`) before the 1 x 1 x 1 conv_shortcut;
  the JAX module has no norm3 (and its converter raises on one).
interop.ltx_vae_config gives the JAX module's form of the three (jax_form),
for the parity tests; no [model] key reaches it.

The decoder is the JAX module's own design (pixel-RMS resnets, nearest 2x
upsampling with the first frame kept once, then a causal convolution),
unverified against a published 0.9.x decoder, which no converter loads; it
unpatchifies in the form's patch order.

State-dict names are Lightricks': `encoder.down_blocks.{k}` is one flat list
of res_x groups (`res_blocks.{j}.conv1.conv`), compressions (`conv`) and
channel-change resnets (`conv1.conv`, `norm3`, `conv_shortcut`); the
statistics are `latents_mean` / `latents_std` here
(`per_channel_statistics.mean-of-means` / `std-of-means` in a checkpoint).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .hunyuan_vae import CausalConv3d


@dataclasses.dataclass(frozen=True)
class LTXVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 128
    patch_size: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: Tuple[int, ...] = (4, 3, 3, 3, 4)  # the last: the mid group
    spatio_temporal_scaling: Tuple[bool, ...] = (True, True, True, False)
    scaling_factor: float = 1.0
    dtype: torch.dtype = torch.float32
    # the JAX module's form: (ph, pw, c) patch order, 2 x latent moments, no
    # norm3 (interop.ltx_vae_config sets it, for the parity tests)
    jax_form: bool = False

    @staticmethod
    def tiny(**kw) -> "LTXVAEConfig":
        """The JAX LTXVAEConfig.tiny sizes (16x in space, 8x in time)."""
        d = dict(latent_channels=16, patch_size=2, block_out_channels=(8, 16, 16, 16),
                 layers_per_block=(1, 1, 1, 1, 1))
        d.update(kw)
        return LTXVAEConfig(**d)

    def encoder_blocks(self) -> List[Tuple[str, int, int, int]]:
        """The encoder's down_blocks in order, (kind, in, out, layers): a
        res_x group ("group") of each width, its compression ("compress")
        where it scales, a channel-change resnet ("change") where the next
        width differs; then the mid group."""
        chans, out = self.block_out_channels, []
        for i, ch in enumerate(chans):
            out.append(("group", ch, ch, self.layers_per_block[i]))
            if self.spatio_temporal_scaling[i]:
                out.append(("compress", ch, ch, 0))
            if i + 1 < len(chans) and ch != chans[i + 1]:
                out.append(("change", ch, chans[i + 1], 1))
        out.append(("group", chans[-1], chans[-1], self.layers_per_block[-1]))
        return out


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Each pixel's channels ([B, C, ...], dim 1) RMS-normalised in f32, no
    affine (LTX's PixelNorm)."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(1, keepdim=True) + eps)).to(x.dtype)


def _conv(in_ch: int, out_ch: int, stride=(1, 1, 1)) -> CausalConv3d:
    return CausalConv3d(in_ch, out_ch, stride=stride, spatial_padding="zeros")


class ResnetBlock3D(nn.Module):
    """pixel norm, SiLU, conv1, pixel norm, SiLU, conv2, plus the input;
    where the width changes, the input through norm3 (an affine LayerNorm
    over its channels, eps 1e-6; not in the JAX form) and the 1 x 1 x 1
    conv_shortcut."""

    def __init__(self, in_ch: int, out_ch: int, norm3: bool = True):
        super().__init__()
        self.conv1 = _conv(in_ch, out_ch)
        self.conv2 = _conv(out_ch, out_ch)
        self.norm3 = (nn.LayerNorm(in_ch, eps=1e-6) if in_ch != out_ch and norm3 else None)
        self.conv_shortcut = nn.Conv3d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(pixel_norm(x)))
        h = self.conv2(F.silu(pixel_norm(h)))
        if self.norm3 is not None:
            x = self.norm3(x.movedim(1, -1)).movedim(-1, 1)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class ResGroup(nn.Module):
    """A res_x group: `layers` resnets of one width."""

    def __init__(self, ch: int, layers: int):
        super().__init__()
        self.res_blocks = nn.ModuleList([ResnetBlock3D(ch, ch) for _ in range(layers)])

    def forward(self, x):
        for block in self.res_blocks:
            x = block(x)
        return x


def patchify(x: torch.Tensor, p: int, jax_form: bool = False) -> torch.Tensor:
    """[B, C, F, H, W] -> [B, C p p, F, H / p, W / p]: the patch channels
    ordered (c, pw, ph) (Lightricks'), or (ph, pw, c) in the JAX form."""
    b, c, f, h, w = x.shape
    x = x.reshape(b, c, f, h // p, p, w // p, p)  # (b, c, f, h', ph, w', pw)
    perm = (0, 4, 6, 1, 2, 3, 5) if jax_form else (0, 1, 6, 4, 2, 3, 5)
    return x.permute(perm).reshape(b, c * p * p, f, h // p, w // p)


def unpatchify(x: torch.Tensor, p: int, channels: int, jax_form: bool = False) -> torch.Tensor:
    """patchify's inverse: [B, C p p, F, h, w] -> [B, C, F, h p, w p]."""
    b, _, f, h, w = x.shape
    if jax_form:
        x = x.reshape(b, p, p, channels, f, h, w).permute(0, 3, 4, 5, 1, 6, 2)
    else:
        x = x.reshape(b, channels, p, p, f, h, w).permute(0, 1, 4, 5, 3, 6, 2)
    return x.reshape(b, channels, f, h * p, w * p)


class Encoder(nn.Module):
    def __init__(self, cfg: LTXVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = _conv(cfg.in_channels * cfg.patch_size ** 2, cfg.block_out_channels[0])
        blocks = []
        for kind, cin, cout, layers in cfg.encoder_blocks():
            if kind == "group":
                blocks.append(ResGroup(cout, layers))
            elif kind == "compress":
                blocks.append(_conv(cin, cout, stride=(2, 2, 2)))
            else:
                blocks.append(ResnetBlock3D(cin, cout, norm3=not cfg.jax_form))
        self.down_blocks = nn.ModuleList(blocks)
        moments = 2 * cfg.latent_channels if cfg.jax_form else cfg.latent_channels + 1
        self.conv_out = _conv(cfg.block_out_channels[-1], moments)

    def forward(self, x):
        """Pixels [B, 3, F, H, W] -> moments [B, z + 1 (2 z), Fl, H / 32, W / 32]."""
        cfg = self.cfg
        h = self.conv_in(patchify(x, cfg.patch_size, cfg.jax_form))
        for block in self.down_blocks:
            h = block(h)
        return self.conv_out(F.silu(pixel_norm(h)))


class UpBlock(nn.Module):
    def __init__(self, ch: int, layers: int, scaling: bool, next_ch: Optional[int]):
        super().__init__()
        self.res_blocks = nn.ModuleList([ResnetBlock3D(ch, ch) for _ in range(layers)])
        self.upsample = _conv(ch, ch) if scaling else None
        self.conv_out = (ResnetBlock3D(ch, next_ch, norm3=False)
                         if next_ch is not None and next_ch != ch else None)

    def forward(self, x):
        for block in self.res_blocks:
            x = block(x)
        if self.upsample is not None:
            x = x.repeat_interleave(2, 3).repeat_interleave(2, 4)
            x = torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(2, 2)], dim=2)
            x = self.upsample(x)
        return x if self.conv_out is None else self.conv_out(x)


class Decoder(nn.Module):
    """The JAX module's decoder (see module docstring)."""

    def __init__(self, cfg: LTXVAEConfig):
        super().__init__()
        self.cfg = cfg
        chans = tuple(reversed(cfg.block_out_channels))
        scaling = tuple(reversed(cfg.spatio_temporal_scaling))
        n = len(chans)
        self.conv_in = _conv(cfg.latent_channels, chans[0])
        self.mid = nn.ModuleList([ResnetBlock3D(chans[0], chans[0])
                                  for _ in range(cfg.layers_per_block[-1])])
        self.up_blocks = nn.ModuleList([
            UpBlock(ch, cfg.layers_per_block[n - 1 - i], scaling[i],
                    chans[i + 1] if i + 1 < n else None)
            for i, ch in enumerate(chans)])
        self.conv_out = _conv(chans[-1], cfg.out_channels * cfg.patch_size ** 2)

    def forward(self, z):
        cfg = self.cfg
        h = self.conv_in(z)
        for block in self.mid:
            h = block(h)
        for block in self.up_blocks:
            h = block(h)
        h = self.conv_out(F.silu(pixel_norm(h)))
        return unpatchify(h, cfg.patch_size, cfg.out_channels, cfg.jax_form)


class LTXVideoVAE(nn.Module):
    """encode(video [B, 3, 1 + 8k, H, W] in [-1, 1]) -> latents [B, z, 1 + k,
    H / 32, W / 32]: the posterior mean (or a sample, given a generator)
    normalised per channel, (mean - latents_mean) / latents_std; decode
    inverts the normalisation. Parameters and compute in cfg.dtype, the
    statistics in f32."""

    def __init__(self, cfg: LTXVAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.to(cfg.dtype)
        z = cfg.latent_channels
        self.latents_mean = nn.Parameter(torch.zeros(z), requires_grad=False)
        self.latents_std = nn.Parameter(torch.ones(z), requires_grad=False)

    def moments(self, video: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, log-variance) [B, z, Fl, h, w] of the posterior: the
        log-variance the last channel of conv_out repeated (uniform), or the
        second half in the JAX form."""
        z = self.config.latent_channels
        out = self.encoder(video.to(self.config.dtype))
        if self.config.jax_form:
            return out[:, :z], out[:, z:]
        return out[:, :z], out[:, z:].expand(-1, z, -1, -1, -1)

    def _stats(self):
        shape = (1, -1, 1, 1, 1)
        return self.latents_mean.reshape(shape), self.latents_std.reshape(shape)

    def encode(self, video: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mean, logvar = self.moments(video)
        if generator is not None:
            std = torch.exp(0.5 * logvar.float().clamp(-30.0, 20.0))
            mean = mean.float() + std * torch.randn(mean.shape, generator=generator,
                                                    device=mean.device)
        m, s = self._stats()
        return (mean.float() - m) / s

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        m, s = self._stats()
        return self.decoder((latents.float() * s + m).to(self.config.dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded weights (no checkpoint): each convolution normal with
        variance 1 / fan_in (drawn in f32, then cast), biases zero, norm3
        one and zero, the statistics zero and one."""
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                tmp = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32,
                                  device=m.weight.device)
                m.weight.copy_(tmp.mul_(m.weight[0].numel() ** -0.5))
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.latents_mean.zero_()
        self.latents_std.fill_(1.0)


# --- checkpoints -------------------------------------------------------------------

_STATS = {"latents_mean": ("per_channel_statistics.mean-of-means",
                           "per_channel_statistics.mean_of_means"),
          "latents_std": ("per_channel_statistics.std-of-means",
                          "per_channel_statistics.std_of_means")}


def _encoder_sequence(enc: Mapping[str, torch.Tensor]):
    """Each `down_blocks.{k}` of a checkpoint's encoder as (kind, in, out,
    layers), read from its keys and shapes."""
    idxs = sorted({int(m.group(1)) for k in enc for m in [re.match(r"down_blocks\.(\d+)\.", k)]
                   if m})
    if idxs != list(range(len(idxs))):
        raise KeyError(f"encoder.down_blocks indices are not 0..n-1: {idxs[:8]}")
    seq = []
    for k in idxs:
        sub = [key[len(f"down_blocks.{k}."):] for key in enc
               if key.startswith(f"down_blocks.{k}.")]
        if any(s.startswith("res_blocks.") for s in sub):
            layers = 1 + max(int(s.split(".")[1]) for s in sub if s.startswith("res_blocks."))
            ch = enc[f"down_blocks.{k}.res_blocks.0.conv1.conv.weight"].shape[0]
            seq.append(("group", ch, ch, layers))
        elif any(s.startswith("conv1.") for s in sub):
            w = enc[f"down_blocks.{k}.conv1.conv.weight"]
            seq.append(("change", w.shape[1], w.shape[0], 1))
        elif "conv.weight" in sub:
            w = enc[f"down_blocks.{k}.conv.weight"]
            seq.append(("compress", w.shape[1], w.shape[0], 0))
        else:
            raise KeyError(f"unrecognized LTX encoder block down_blocks.{k}: {sorted(sub)[:6]}")
    return seq


def infer_ltx_vae_config(sd: Mapping[str, torch.Tensor], dtype=torch.float32) -> LTXVAEConfig:
    """The published encoder's topology from a checkpoint (a `vae.` prefix
    dropped): the down_blocks sequence fitted to [group][compress?][change?]*
    + mid group (what convert_ltx_vae finds), the patch from conv_in's
    input channels, the latent width conv_out's rows - 1 (uniform
    log-variance). GroupNorm or attention keys (another VAE family) raise."""
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    if not enc:
        raise KeyError("no encoder.* keys in the LTX VAE checkpoint")
    bad = [k for k in enc if "norm1.weight" in k or "attention" in k or "attn" in k]
    if bad:
        raise KeyError(f"unsupported LTX VAE variant (unexpected key {bad[0]}); expected "
                       "pixel-norm resnets without attention")
    seq = _encoder_sequence(enc)
    chans, layers, scaling = [], [], []
    i = 0
    while i < len(seq) - 1:
        kind, _, ch, n = seq[i]
        if kind != "group":
            raise KeyError(f"LTX encoder sequence mismatch at down_blocks.{i}: expected a "
                           f"res_x group, got {kind}")
        chans.append(ch)
        layers.append(n)
        i += 1
        scaled = i < len(seq) - 1 and seq[i][0] == "compress"
        scaling.append(scaled)
        i += int(scaled)
        if i < len(seq) - 1 and seq[i][0] == "change":
            i += 1
    if i != len(seq) - 1 or seq[-1][0] != "group":
        raise KeyError("the LTX encoder must end in an unscaled mid res group")
    layers.append(seq[-1][3])
    in_dim = enc["conv_in.conv.weight"].shape[1]
    patch = int(round((in_dim / 3) ** 0.5))
    if 3 * patch * patch != in_dim:
        raise KeyError(f"cannot read the patch size from conv_in's {in_dim} input channels")
    cfg = LTXVAEConfig(latent_channels=enc["conv_out.conv.weight"].shape[0] - 1,
                       patch_size=patch, block_out_channels=tuple(chans),
                       layers_per_block=tuple(layers), spatio_temporal_scaling=tuple(scaling),
                       dtype=dtype)
    if [s[0] for s in cfg.encoder_blocks()] != [s[0] for s in seq]:
        raise KeyError("the LTX encoder's channel-change resnets do not follow its widths")
    return cfg


def convert_ltx_vae(sd: Mapping[str, torch.Tensor],
                    dtype=torch.float32) -> Tuple[LTXVAEConfig, Dict[str, torch.Tensor]]:
    """A Lightricks checkpoint (or a single file's `vae.*` keys) -> (config,
    the port's encoder and statistics state dict). Each conv_shortcut is
    taken as `.weight` (Lightricks' nn.Conv3d) or `.conv.weight` (diffusers'
    causal conv); norm3 as it is. The decoder's keys are not read (no
    published decoder is mirrored); a key the encoder needs and the
    checkpoint lacks, or any other key left over, raises KeyError naming
    them."""
    from .weights import TrackedDict

    sd = {(k[4:] if k.startswith("vae.") else k): v for k, v in sd.items()}
    cfg = infer_ltx_vae_config(sd, dtype)
    tracked = TrackedDict({k: v for k, v in sd.items() if not k.startswith("decoder.")},
                          "LTX VAE checkpoint")
    with torch.device("meta"):
        want = LTXVideoVAE(dataclasses.replace(cfg, dtype=torch.float32)).state_dict()
    out = {}
    for key in want:
        if key.startswith("decoder."):
            continue
        if key in _STATS:
            name = next((n for n in _STATS[key] if n in tracked), _STATS[key][0])
            out[key] = tracked[name].float().reshape(-1)
            continue
        alt = re.sub(r"conv_shortcut\.(weight|bias)$", r"conv_shortcut.conv.\1", key)
        out[key] = tracked[key if key in tracked or alt not in tracked else alt]
    for key in list(tracked):  # the statistics this model does not use
        if key.startswith("per_channel_statistics.") and key not in tracked.read:
            tracked.read.add(key)
    tracked.check_all_read()
    return cfg, out


def load_ltx_vae(path, dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None) -> LTXVideoVAE:
    """The VAE of a checkpoint file or folder (a VAE alone, or LTX-Video's
    single file with its `vae.*` keys), its encoder's topology from its
    keys, in `dtype` on `device` (default the CPU), frozen; the decoder
    keeps seeded weights (init_weights, `generator` or seed 0)."""
    from .weights import load_state_dict_any

    p = Path(path)
    if p.is_dir() and (p / "vae").is_dir():
        p = p / "vae"
    sd = load_state_dict_any(p)
    if any(k.startswith("vae.") for k in sd):
        sd = {k: v for k, v in sd.items() if k.startswith("vae.")}
    cfg, weights = convert_ltx_vae(sd, dtype)
    with torch.device("meta"):
        vae = LTXVideoVAE(cfg)
    vae = vae.to_empty(device=device or "cpu")
    vae.init_weights(generator or torch.Generator(device=device or "cpu").manual_seed(0))
    for k, v in weights.items():
        vae.get_parameter(k).data.copy_(v)
    return vae.eval().requires_grad_(False)


def ltx_vae_state_dict_for_checkpoint(vae: LTXVideoVAE) -> Dict[str, torch.Tensor]:
    """The encoder and statistics as a Lightricks checkpoint holds them
    (`encoder.*`, `per_channel_statistics.mean-of-means` /
    `std-of-means`): what convert_ltx_vae reads back."""
    out = {k: v for k, v in vae.state_dict().items() if k.startswith("encoder.")}
    out["per_channel_statistics.mean-of-means"] = vae.latents_mean.detach()
    out["per_channel_statistics.std-of-means"] = vae.latents_std.detach()
    return out
