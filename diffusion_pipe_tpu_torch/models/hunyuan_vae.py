"""HunyuanVideo causal 3D VAE (diffusers AutoencoderKLHunyuanVideo) as a
PyTorch module.

Counterpart of diffusion_pipe_tpu/models/hunyuan_vae.py, in the published
form, where the JAX module departs from it in four ways (ROADMAP C):
- every causal convolution pads with the edge values on every side, (k - 1,
  0) frames in time and k // 2 pixels on both sides in space (diffusers'
  F.pad(mode="replicate")); the JAX module zero-pads in space;
- the mid blocks' attention (one head as wide as the block) runs over the
  whole clip's (f h w) tokens, a token of frame i seeing every token of
  frames <= i (prepare_causal_attention_mask); the JAX module attends within
  each frame. Both agree on frame 0, so on every image;
- the decoder doubles the frames in up blocks n - 1 - temporal_downsamples
  .. n - 2 (1 and 2 of 4), as the encoder halves them; the JAX module in
  blocks 0 .. temporal_downsamples - 1;
- quant_conv (2z -> 2z) follows the encoder and post_quant_conv (z -> z)
  precedes the decoder, both 1 x 1 x 1; the JAX module has neither.
interop.hunyuan_vae_config gives the JAX module's form of the first three
(jax_form) and leaves out the quant convolutions.

GroupNorm(32) reduces over (T, H, W) and the channels of each group, as in
both packages. The mid attention is plain torch (matmul and softmax, its
width of 512 no head dim of the flash kernels), one query frame at a time
against the frames up to it: at 9 x 64 x 64 latents a frame's f32 logits
are 0.6 GB. Encode returns the posterior mean times scaling_factor; decode
divides by it. Tiling is not ported (the JAX package dropped it too).

Layout: torch's [B, C, T, H, W]; the module names and state-dict keys are
diffusers' (`encoder.down_blocks.{i}.resnets.{j}.conv1.conv.weight`,
`.downsamplers.0.conv.conv`, `mid_block.attentions.0.to_out.0`, ...).
convert_hunyuan_vae takes diffusers' keys, the original (SD-VAE) dialect
and keys without the causal convolutions' inner `.conv` (the JAX
converter's reading).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class HunyuanVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    temporal_downsamples: int = 2   # 4x in time
    scaling_factor: float = 0.476986
    norm_groups: int = 32
    dtype: torch.dtype = torch.float32
    quant_convs: bool = True
    # the JAX module's form: zero spatial padding, the mid attention within
    # each frame, up blocks 0 .. temporal_downsamples - 1 doubling the frames
    # (interop.hunyuan_vae_config sets it, for the parity tests)
    jax_form: bool = False

    @staticmethod
    def tiny(**kw) -> "HunyuanVAEConfig":
        """The JAX HunyuanVAEConfig.tiny sizes."""
        d = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, latent_channels=4)
        d.update(kw)
        return HunyuanVAEConfig(**d)

    def time_down(self, i: int) -> bool:
        """Whether down block i halves the frames (every package: the last
        temporal_downsamples blocks before the final one)."""
        n = len(self.block_out_channels)
        return n - 1 - self.temporal_downsamples <= i < n - 1

    def time_up(self, i: int) -> bool:
        """Whether up block i doubles the frames."""
        if self.jax_form:
            return i < self.temporal_downsamples
        return self.time_down(i)


class CausalConv3d(nn.Module):
    """A causal 3D convolution: (k - 1, 0) frames padded by repeating the
    first, k // 2 pixels on both sides padded by `spatial_padding`
    ("replicate": HunyuanVideoCausalConv3d's edge values; "zeros": LTX's
    CausalConv3d and the JAX CausalConv3dR), then nn.Conv3d."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride=(1, 1, 1),
                 spatial_padding: str = "replicate"):
        super().__init__()
        if spatial_padding not in ("replicate", "zeros"):
            raise ValueError(f"spatial_padding {spatial_padding!r}: 'replicate' or 'zeros'")
        self.kernel, self.spatial_padding = kernel, spatial_padding
        zeros = kernel // 2 if spatial_padding == "zeros" else 0
        self.conv = nn.Conv3d(in_ch, out_ch, kernel, stride, padding=(0, zeros, zeros))

    def forward(self, x):
        k = self.kernel
        if k > 1:
            if self.spatial_padding == "replicate":
                x = F.pad(x, (k // 2, k // 2, k // 2, k // 2, k - 1, 0), mode="replicate")
            else:
                x = torch.cat([x[:, :, :1].expand(-1, -1, k - 1, -1, -1), x], dim=2)
        return self.conv(x)


def _padding(cfg: HunyuanVAEConfig) -> str:
    return "zeros" if cfg.jax_form else "replicate"


def _norm(cfg: HunyuanVAEConfig, ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(cfg.norm_groups, ch), ch, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _norm(cfg, in_ch)
        self.conv1 = CausalConv3d(in_ch, out_ch, spatial_padding=_padding(cfg))
        self.norm2 = _norm(cfg, out_ch)
        self.conv2 = CausalConv3d(out_ch, out_ch, spatial_padding=_padding(cfg))
        self.conv_shortcut = (CausalConv3d(in_ch, out_ch, kernel=1) if in_ch != out_ch
                              else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class MidAttention(nn.Module):
    """The mid block's single-head attention with a residual (diffusers
    Attention with group_norm, residual_connection), frame-causal over the
    whole clip or within each frame."""

    def __init__(self, cfg: HunyuanVAEConfig, ch: int):
        super().__init__()
        self.causal = not cfg.jax_form
        self.group_norm = _norm(cfg, ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, t, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 4, 1).reshape(b, t, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        scale = c ** -0.5
        outs = []
        for i in range(t):
            # keys of frame i alone, or of frames 0..i
            lo = 0 if self.causal else i
            keys = k[:, lo:i + 1].reshape(b, -1, c)
            vals = v[:, lo:i + 1].reshape(b, -1, c)
            logits = torch.matmul(q[:, i].float(), keys.float().transpose(1, 2)) * scale
            outs.append(torch.matmul(logits.softmax(-1).to(v.dtype), vals))
        y = self.to_out[0](torch.stack(outs, dim=1))
        return x + y.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


class MidBlock(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(cfg, ch, ch), ResnetBlock(cfg, ch, ch)])
        self.attentions = nn.ModuleList([MidAttention(cfg, ch)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Resample(nn.Module):
    """A down block's stride-(t, 2, 2) causal convolution, or an up block's
    nearest 2x in space (and in time, the first frame kept once) before
    one."""

    def __init__(self, cfg: HunyuanVAEConfig, ch: int, time: bool, up: bool):
        super().__init__()
        self.time, self.up = time, up
        stride = (1, 1, 1) if up else (2 if time else 1, 2, 2)
        self.conv = CausalConv3d(ch, ch, stride=stride, spatial_padding=_padding(cfg))

    def forward(self, x):
        if self.up:
            first = x[:, :, :1].repeat_interleave(2, 3).repeat_interleave(2, 4)
            rest = x[:, :, 1:].repeat_interleave(2, 3).repeat_interleave(2, 4)
            if self.time:
                rest = rest.repeat_interleave(2, 2)
            x = torch.cat([first, rest], dim=2)
        return self.conv(x)


class UpDownBlock(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, in_ch: int, out_ch: int, layers: int,
                 resample: Optional[Tuple[bool, bool]]):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(cfg, in_ch if j == 0 else out_ch, out_ch)
                                      for j in range(layers)])
        name = None if resample is None else ("upsamplers" if resample[1] else "downsamplers")
        self.sampler = name
        if name:
            setattr(self, name, nn.ModuleList([Resample(cfg, out_ch, *resample)]))

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.sampler:
            x = getattr(self, self.sampler)[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig):
        super().__init__()
        chans, n = cfg.block_out_channels, len(cfg.block_out_channels)
        self.conv_in = CausalConv3d(cfg.in_channels, chans[0], spatial_padding=_padding(cfg))
        self.down_blocks = nn.ModuleList([
            UpDownBlock(cfg, chans[max(i - 1, 0)], ch, cfg.layers_per_block,
                        (cfg.time_down(i), False) if i < n - 1 else None)
            for i, ch in enumerate(chans)])
        self.mid_block = MidBlock(cfg, chans[-1])
        self.conv_norm_out = _norm(cfg, chans[-1])
        self.conv_out = CausalConv3d(chans[-1], 2 * cfg.latent_channels,
                                     spatial_padding=_padding(cfg))

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig):
        super().__init__()
        chans, n = tuple(reversed(cfg.block_out_channels)), len(cfg.block_out_channels)
        self.conv_in = CausalConv3d(cfg.latent_channels, chans[0], spatial_padding=_padding(cfg))
        self.mid_block = MidBlock(cfg, chans[0])
        self.up_blocks = nn.ModuleList([
            UpDownBlock(cfg, chans[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                        (cfg.time_up(i), True) if i < n - 1 else None)
            for i, ch in enumerate(chans)])
        self.conv_norm_out = _norm(cfg, chans[-1])
        self.conv_out = CausalConv3d(chans[-1], cfg.out_channels, spatial_padding=_padding(cfg))

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class HunyuanVAE(nn.Module):
    """encode(video [B, 3, 1 + 4k, H, W] in [-1, 1]) -> latents [B, z, 1 + k,
    H / 8, W / 8] (the posterior mean x scaling_factor); decode inverts it.
    Parameters and compute in cfg.dtype."""

    def __init__(self, cfg: HunyuanVAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        z = cfg.latent_channels
        self.quant_conv = nn.Conv3d(2 * z, 2 * z, 1) if cfg.quant_convs else None
        self.post_quant_conv = nn.Conv3d(z, z, 1) if cfg.quant_convs else None
        self.to(cfg.dtype)

    def encode_moments(self, video: torch.Tensor) -> torch.Tensor:
        moments = self.encoder(video.to(self.config.dtype))
        return moments if self.quant_conv is None else self.quant_conv(moments)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        mean = self.encode_moments(video)[:, :self.config.latent_channels]
        return mean * self.config.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        z = latents.to(self.config.dtype) / self.config.scaling_factor
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded weights (no checkpoint): each convolution and linear normal
        with variance 1 / fan_in (drawn in f32, then cast), biases zero,
        norms one and zero."""
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.Linear)):
                w = m.weight
                tmp = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                                  device=w.device)
                w.copy_(tmp.mul_(w[0].numel() ** -0.5))
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


# --- checkpoints -------------------------------------------------------------------

_SD_DIALECT = (
    (r"\.down\.(\d+)\.block\.(\d+)\.", r".down_blocks.\1.resnets.\2."),
    (r"\.up\.(\d+)\.block\.(\d+)\.", r".up_blocks.\1.resnets.\2."),
    (r"\.down\.(\d+)\.downsample\.conv\.", r".down_blocks.\1.downsamplers.0.conv."),
    (r"\.up\.(\d+)\.upsample\.conv\.", r".up_blocks.\1.upsamplers.0.conv."),
    (r"\.mid\.block_1\.", ".mid_block.resnets.0."),
    (r"\.mid\.block_2\.", ".mid_block.resnets.1."),
    (r"\.mid\.attn_1\.", ".mid_block.attentions.0."),
    (r"\.norm_out\.", ".conv_norm_out."),
)
_SD_ATTENTION = ((".q.", ".to_q."), (".k.", ".to_k."), (".v.", ".to_v."),
                 (".proj_out.", ".to_out.0."), (".norm.", ".group_norm."))


def normalize_hunyuan_vae_dialect(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The original / ComfyUI SD-VAE naming (encoder.down.N.block.M,
    mid.block_1, attention q / k / v / proj_out as 1 x 1 convolutions,
    norm_out, decoder up blocks indexed from the lowest resolution) as
    diffusers' (the JAX function's renames). Diffusers-layout dicts pass
    through."""
    if any(".down_blocks." in k for k in sd) or not any(".down." in k for k in sd):
        return dict(sd)
    out = {}
    for k, v in sd.items():
        for pat, rep in _SD_DIALECT:
            k = re.sub(pat, rep, k)
        if ".attentions.0." in k:
            for old, new in _SD_ATTENTION:
                k = k.replace(old, new)
            if k.endswith(".weight") and v.dim() > 2:
                v = v.reshape(v.shape[0], v.shape[1])
        out[k] = v
    ups = {int(m.group(1)) for k in out for m in [re.match(r"decoder\.up_blocks\.(\d+)\.", k)]
           if m}
    if ups:
        n = max(ups)
        out = {re.sub(r"^decoder\.up_blocks\.(\d+)\.",
                      lambda m: f"decoder.up_blocks.{n - int(m.group(1))}.", k): v
               for k, v in out.items()}
    return out


def infer_hunyuan_vae_config(sd: Mapping[str, torch.Tensor], temporal_downsamples: int = 2,
                             scaling_factor: Optional[float] = None,
                             dtype=torch.float32) -> HunyuanVAEConfig:
    """The topology of a diffusers-dialect state dict: the block count and
    widths from each down block's first resnet, the layers per block from
    block 0, the latent width from encoder.conv_out, the quant convolutions
    from their keys. Strides do not show in shapes, so
    temporal_downsamples stays a parameter (4x in time: 2)."""
    idxs = sorted({int(m.group(1)) for k in sd
                   for m in [re.match(r"encoder\.down_blocks\.(\d+)\.", k)] if m})
    if not idxs:
        raise KeyError("no encoder.down_blocks.* keys in the VAE checkpoint")

    def rows(key):
        for k in (f"{key}.conv.weight", f"{key}.weight"):
            if k in sd:
                return int(sd[k].shape[0])
        raise KeyError(f"the VAE checkpoint lacks {key}.conv.weight")

    chans = tuple(rows(f"encoder.down_blocks.{i}.resnets.0.conv1") for i in idxs)
    layers = 1 + max(int(m.group(1)) for k in sd
                     for m in [re.match(r"encoder\.down_blocks\.0\.resnets\.(\d+)\.", k)] if m)
    kw = {} if scaling_factor is None else {"scaling_factor": float(scaling_factor)}
    return HunyuanVAEConfig(latent_channels=rows("encoder.conv_out") // 2,
                            block_out_channels=chans, layers_per_block=layers,
                            temporal_downsamples=temporal_downsamples,
                            quant_convs="quant_conv.weight" in sd, dtype=dtype, **kw)


def convert_hunyuan_vae(sd: Mapping[str, torch.Tensor],
                        cfg: HunyuanVAEConfig) -> Dict[str, torch.Tensor]:
    """A checkpoint (either dialect) -> the port's state dict for cfg. A
    causal convolution's weight is taken as `<name>.conv.weight` (diffusers,
    hyvideo) or `<name>.weight`. A key the model needs and sd lacks, or one
    it does not take, raises KeyError naming them."""
    from .weights import TrackedDict

    sd = TrackedDict(normalize_hunyuan_vae_dialect(sd), "VAE checkpoint")
    with torch.device("meta"):
        want = HunyuanVAE(dataclasses.replace(cfg, dtype=torch.float32)).state_dict()
    out = {}
    for key in want:
        alt = key.replace(".conv.weight", ".weight").replace(".conv.bias", ".bias")
        out[key] = sd[key] if key in sd or alt not in sd else sd[alt]
    sd.check_all_read()
    return out


def load_hunyuan_vae(path, dtype: torch.dtype = torch.float32, device=None,
                     temporal_downsamples: int = 2,
                     scaling_factor: Optional[float] = None) -> HunyuanVAE:
    """The VAE of a checkpoint file or folder (a diffusers `vae/` folder, a
    hyvideo pytorch_model.pt, a file whose keys carry a `vae.` prefix), its
    topology from its shapes, latents scaled by `scaling_factor` (the
    config's default if None), in `dtype` on `device` (default the CPU),
    frozen."""
    from .weights import load_state_dict_any

    p = Path(path)
    if p.is_dir() and (p / "vae").is_dir():
        p = p / "vae"
    sd = normalize_hunyuan_vae_dialect(
        {(k[4:] if k.startswith("vae.") else k): v for k, v in load_state_dict_any(p).items()})
    cfg = infer_hunyuan_vae_config(sd, temporal_downsamples, scaling_factor, dtype=dtype)
    weights = convert_hunyuan_vae(sd, cfg)
    with torch.device("meta"):
        vae = HunyuanVAE(cfg)
    vae = vae.to_empty(device=device or "cpu")
    vae.load_state_dict({k: v.to(dtype) for k, v in weights.items()})
    return vae.eval().requires_grad_(False)
