"""KL autoencoder (the Flux image VAE) in PyTorch, NCHW.

Counterpart of diffusion_pipe_tpu/models/autoencoder_kl.py: the same
architecture and parameter names (`down_{i}_res_{j}`, `mid_attn`,
`up_{i}_upsample`, ...), so interop.vae_to_state_dict maps the JAX
parameters onto it, and convert_diffusers_vae maps a diffusers
AutoencoderKL state dict. The mid-block attention is the plain product of
the JAX module (no flash kernel there either); convolutions, group norms and
matmuls are torch's own. The caching phase runs `encode` on the card.

Config presets: `flux` (16 latent channels, scaling 0.3611, shift 0.1159,
no quant convs), `sdxl` and `sd` (4 latent channels, scaling 0.13025 and
0.18215, no shift, with the quant_conv and post_quant_conv 1 x 1
convolutions) and `tiny` (a small random VAE for tests). load_image_vae
reads any of them from diffusers, original-SD (`first_stage_model.`) or
ComfyUI (`vae.`) keys, the topology inferred from the weights' shapes.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    use_quant_conv: bool = False
    dtype: torch.dtype = torch.float32

    @staticmethod
    def flux(**kw) -> "VAEConfig":
        return VAEConfig(**kw)

    @staticmethod
    def sdxl(**kw) -> "VAEConfig":
        return VAEConfig(**{**dict(latent_channels=4, scaling_factor=0.13025, shift_factor=0.0,
                                   use_quant_conv=True), **kw})

    @staticmethod
    def sd3(**kw) -> "VAEConfig":
        """The SD3 / SD3.5 VAE: 16 channels, no quant conv."""
        return VAEConfig(**{**dict(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609,
                                   use_quant_conv=False), **kw})

    @staticmethod
    def sd(**kw) -> "VAEConfig":
        return VAEConfig(**{**dict(latent_channels=4, scaling_factor=0.18215, shift_factor=0.0,
                                   use_quant_conv=True), **kw})

    @staticmethod
    def tiny(**kw) -> "VAEConfig":
        return VAEConfig(**{**dict(latent_channels=4, block_out_channels=(8, 16),
                                   norm_num_groups=4, layers_per_block=1,
                                   scaling_factor=1.0, shift_factor=0.0), **kw})

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def _norm(groups: int, channels: int, dtype) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=1e-6, dtype=dtype)


def _conv(cin: int, cout: int, k: int, dtype, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, dtype=dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, dtype):
        super().__init__()
        self.norm1 = _norm(groups, cin, dtype)
        self.conv1 = _conv(cin, cout, 3, dtype, padding=1)
        self.norm2 = _norm(groups, cout, dtype)
        self.conv2 = _conv(cout, cout, 3, dtype, padding=1)
        self.conv_shortcut = _conv(cin, cout, 1, dtype) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the H*W positions, softmax(q k^T / sqrt(C))."""

    def __init__(self, channels: int, groups: int, dtype):
        super().__init__()
        self.group_norm = _norm(groups, channels, dtype)
        self.to_q = nn.Linear(channels, channels, dtype=dtype)
        self.to_k = nn.Linear(channels, channels, dtype=dtype)
        self.to_v = nn.Linear(channels, channels, dtype=dtype)
        self.to_out = nn.Linear(channels, channels, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
        y = self.to_out(attn @ v)
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt, g, chans = cfg.dtype, cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = _conv(cfg.in_channels, chans[0], 3, dt, padding=1)
        self.down_names = []
        cin = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(cin, ch, g, dt))
                self.down_names.append((f"down_{i}_res_{j}", False))
                cin = ch
            if i < len(chans) - 1:
                self.add_module(f"down_{i}_downsample", _conv(ch, ch, 3, dt, stride=2))
                self.down_names.append((f"down_{i}_downsample", True))
        self.mid_res_0 = ResnetBlock(cin, cin, g, dt)
        self.mid_attn = AttnBlock(cin, g, dt)
        self.mid_res_1 = ResnetBlock(cin, cin, g, dt)
        self.conv_norm_out = _norm(g, cin, dt)
        self.conv_out = _conv(cin, 2 * cfg.latent_channels, 3, dt, padding=1)
        self.quant_conv = (_conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, dt)
                           if cfg.use_quant_conv else None)

    def forward(self, x):
        h = self.conv_in(x)
        for name, downsample in self.down_names:
            if downsample:  # diffusers Downsample2D: pad right/bottom, stride-2 conv
                h = F.pad(h, (0, 1, 0, 1))
            h = getattr(self, name)(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        if self.quant_conv is not None:
            h = self.quant_conv(h)
        return h  # [B, 2 * latent, h, w]: mean, logvar


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt, g, chans = cfg.dtype, cfg.norm_num_groups, cfg.block_out_channels
        lat = cfg.latent_channels
        self.post_quant_conv = _conv(lat, lat, 1, dt) if cfg.use_quant_conv else None
        ch = chans[-1]
        self.conv_in = _conv(lat, ch, 3, dt, padding=1)
        self.mid_res_0 = ResnetBlock(ch, ch, g, dt)
        self.mid_attn = AttnBlock(ch, g, dt)
        self.mid_res_1 = ResnetBlock(ch, ch, g, dt)
        self.up_names = []
        cin = ch
        for i, ch in enumerate(reversed(chans)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock(cin, ch, g, dt))
                self.up_names.append((f"up_{i}_res_{j}", False))
                cin = ch
            if i < len(chans) - 1:
                self.add_module(f"up_{i}_upsample", _conv(ch, ch, 3, dt, padding=1))
                self.up_names.append((f"up_{i}_upsample", True))
        self.conv_norm_out = _norm(g, cin, dt)
        self.conv_out = _conv(cin, cfg.in_channels, 3, dt, padding=1)

    def forward(self, z):
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(self.conv_in(z))))
        for name, upsample in self.up_names:
            if upsample:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """encode(x NCHW in [-1, 1]) -> scaled latents NCHW; decode inverts."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights: normal kernels scaled by 1/sqrt(fan in) (the JAX
        module's lecun-normal, untruncated), zero biases, group-norm scale
        one and bias zero."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32,
                                device=m.weight.device)
                m.weight.copy_(w / math.sqrt(fan_in))
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def encode_moments(self, pixels):
        moments = self.encoder(pixels.to(self.config.dtype))
        return moments.chunk(2, dim=1)

    def encode(self, pixels):
        """The posterior's mode, scaled and shifted as diffusers does:
        z = (mean - shift) * scale (what the caching phase stores)."""
        mean, _ = self.encode_moments(pixels)
        return (mean - self.config.shift_factor) * self.config.scaling_factor

    def decode(self, latents):
        z = latents.to(self.config.dtype) / self.config.scaling_factor + self.config.shift_factor
        return self.decoder(z)


# --- diffusers weight conversion -------------------------------------------


def _diffusers_names(config: VAEConfig):
    """(this module's name, the diffusers name) of every weight and bias.
    The layouts agree (torch's on both sides); only the names differ."""
    pairs = []

    def put(dst, src):
        pairs.extend((f"{dst}.{p}", f"{src}.{p}") for p in ("weight", "bias"))

    def res(dst, src, shortcut):
        for name in ("norm1", "conv1", "norm2", "conv2") + (("conv_shortcut",) if shortcut else ()):
            put(f"{dst}.{name}", f"{src}.{name}")

    def attn(dst, src):
        for name in ("group_norm", "to_q", "to_k", "to_v"):
            put(f"{dst}.{name}", f"{src}.{name}")
        put(f"{dst}.to_out", f"{src}.to_out.0")

    chans = config.block_out_channels
    n = len(chans)
    put("encoder.conv_in", "encoder.conv_in")
    cin = chans[0]
    for i, ch in enumerate(chans):
        for j in range(config.layers_per_block):
            res(f"encoder.down_{i}_res_{j}", f"encoder.down_blocks.{i}.resnets.{j}", cin != ch)
            cin = ch
        if i < n - 1:
            put(f"encoder.down_{i}_downsample", f"encoder.down_blocks.{i}.downsamplers.0.conv")
    for part in ("encoder", "decoder"):
        res(f"{part}.mid_res_0", f"{part}.mid_block.resnets.0", False)
        res(f"{part}.mid_res_1", f"{part}.mid_block.resnets.1", False)
        attn(f"{part}.mid_attn", f"{part}.mid_block.attentions.0")
        put(f"{part}.conv_norm_out", f"{part}.conv_norm_out")
        put(f"{part}.conv_out", f"{part}.conv_out")
    if config.use_quant_conv:
        put("encoder.quant_conv", "quant_conv")
        put("decoder.post_quant_conv", "post_quant_conv")
    put("decoder.conv_in", "decoder.conv_in")
    cin = chans[-1]
    for i, ch in enumerate(reversed(chans)):
        for j in range(config.layers_per_block + 1):
            res(f"decoder.up_{i}_res_{j}", f"decoder.up_blocks.{i}.resnets.{j}", cin != ch)
            cin = ch
        if i < n - 1:
            put(f"decoder.up_{i}_upsample", f"decoder.up_blocks.{i}.upsamplers.0.conv")
    return pairs


def convert_diffusers_vae(sd: Dict[str, torch.Tensor], config: VAEConfig) -> Dict[str, torch.Tensor]:
    """diffusers AutoencoderKL state dict -> this module's state dict."""
    return {ours: sd[theirs] for ours, theirs in _diffusers_names(config)}


def diffusers_vae_state_dict(vae: AutoencoderKL) -> Dict[str, torch.Tensor]:
    """This module's weights under the diffusers names (the layout a
    diffusers checkpoint is written in); the inverse of
    convert_diffusers_vae."""
    ours = vae.state_dict()
    return {theirs: ours[mine] for mine, theirs in _diffusers_names(vae.config)}


# --- universal image-VAE loader ----------------------------------------------


def convert_sd_vae_keys_to_diffusers(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Original SD first_stage_model keys -> diffusers AutoencoderKL keys;
    the mid-block attention's 1 x 1 convolution weights [O, I, 1, 1] become
    linear weights [O, I]. (The JAX function renames the attention's
    "k." inside "mid_block." too, giving "mid_blocto_k."; not copied.)"""
    renames = [("conv_shortcut", "nin_shortcut"), ("conv_norm_out", "norm_out"),
               ("mid_block.attentions.0.", "mid.attn_1.")]
    for i in range(4):
        for j in range(2):
            renames.append((f"encoder.down_blocks.{i}.resnets.{j}.", f"encoder.down.{i}.block.{j}."))
        if i < 3:
            renames.append((f"down_blocks.{i}.downsamplers.0.", f"down.{i}.downsample."))
            renames.append((f"up_blocks.{i}.upsamplers.0.", f"up.{3-i}.upsample."))
        for j in range(3):
            renames.append((f"decoder.up_blocks.{i}.resnets.{j}.", f"decoder.up.{3-i}.block.{j}."))
    for i in range(2):
        renames.append((f"mid_block.resnets.{i}.", f"mid.block_{i+1}."))
    attn_renames = [("group_norm.", "norm."), ("to_q.", "q."), ("to_k.", "k."), ("to_v.", "v."),
                    ("to_out.0.", "proj_out.")]
    out = {}
    for k, v in sd.items():
        nk = k
        for hf_part, sd_part in renames:
            nk = nk.replace(sd_part, hf_part)
        if "mid_block.attentions.0." in nk:
            # renamed after the block prefix only ("k." is also the end of
            # "mid_block.")
            head, tail = nk.split("mid_block.attentions.0.", 1)
            for hf_part, sd_part in attn_renames:
                if tail.startswith(sd_part):
                    tail = hf_part + tail[len(sd_part):]
            nk = f"{head}mid_block.attentions.0.{tail}"
            if v.dim() == 4 and v.shape[2] == v.shape[3] == 1:
                v = v.reshape(v.shape[0], v.shape[1])
        out[nk] = v
    return out


def infer_vae_config_from_sd(sd: Dict[str, torch.Tensor], **overrides) -> VAEConfig:
    """The AutoencoderKL topology of a diffusers-keyed state dict: depth,
    widths, resnets a stage, latent channels and quant convs from the
    tensors; scaling and shift those of Flux (16 channels) or SDXL (4),
    else 1 and 0, unless overridden."""
    blocks = []
    while f"encoder.down_blocks.{len(blocks)}.resnets.0.conv1.weight" in sd:
        blocks.append(int(sd[f"encoder.down_blocks.{len(blocks)}.resnets.0.conv1.weight"].shape[0]))
    if not blocks:
        raise ValueError("not an AutoencoderKL-shaped state dict")
    layers = 0
    while f"encoder.down_blocks.0.resnets.{layers}.conv1.weight" in sd:
        layers += 1
    latent = int(sd["encoder.conv_out.weight"].shape[0]) // 2
    defaults = {16: dict(scaling_factor=0.3611, shift_factor=0.1159),
                4: dict(scaling_factor=0.13025, shift_factor=0.0)}
    kw = dict(latent_channels=latent, block_out_channels=tuple(blocks), layers_per_block=layers,
              use_quant_conv="quant_conv.weight" in sd,
              **defaults.get(latent, dict(scaling_factor=1.0, shift_factor=0.0)))
    kw.update(overrides)
    return VAEConfig(**kw)


def load_image_vae(path, device=None, **config_overrides):
    """Any AutoencoderKL-family image VAE from a safetensors file or folder
    (diffusers, original-SD `first_stage_model.` or ComfyUI `vae.` keys),
    its topology inferred from the shapes: (vae on `device`, frozen, config).
    config_overrides (e.g. dtype, scaling_factor) go to the config. A
    FLUX.2 VAE's batch-norm statistics of the 2 x 2-packed latents
    (`bn.running_mean` / `bn.running_var`, with config.json's batch_norm_eps
    beside a folder, else 1e-4) become `vae.latent_bn` = (mean, var, eps);
    None for the other VAEs."""
    from .weights import load_safetensors_dir

    sd = {}
    for k, v in load_safetensors_dir(path).items():
        for p in ("first_stage_model.", "vae."):
            if k.startswith(p):
                k = k[len(p):]
                break
        sd[k] = v
    if any(k.startswith("encoder.down.") for k in sd):
        sd = convert_sd_vae_keys_to_diffusers(sd)
    cfg = infer_vae_config_from_sd(sd, **config_overrides)
    with torch.device("meta"):
        vae = AutoencoderKL(cfg)
    vae = vae.to_empty(device=device or "cpu")
    vae.load_state_dict({k: v.to(cfg.dtype) for k, v in convert_diffusers_vae(sd, cfg).items()})
    vae.latent_bn = None
    if "bn.running_mean" in sd:
        eps = 1e-4
        cfg_json = Path(path) / "config.json"
        if cfg_json.is_file():
            eps = float(json.loads(cfg_json.read_text()).get("batch_norm_eps", eps))
        vae.latent_bn = (sd["bn.running_mean"].float().to(device or "cpu"),
                         sd["bn.running_var"].float().to(device or "cpu"), eps)
    return vae.eval().requires_grad_(False), cfg
