"""Wan 2.1 VAE checkpoints onto the port's WanVideoVAE, and back.

Counterpart of diffusion_pipe_tpu/models/wan_vae_convert.py: the reference
checkpoint layout (an encoder with nn.Sequential `downsamples` / `middle` /
`head`, the quant convolutions `conv1` / `conv2`, a decoder with
`upsamples`) maps onto the port's named modules by replaying the same
construction loops. torch's [out, in, ...] layouts carry over as they are;
an RMS norm's gamma [C, 1, 1(, 1)] flattens to [C] and a 1x1 Conv2d of the
bottleneck attention becomes a Linear. `vae.` / `model.` prefixes are
stripped. diffusers' AutoencoderKLWan / AutoencoderKLQwenImage layout
(Qwen-Image's `vae/` folder) is renamed onto the reference layout first
(diffusers_key_map). wan_vae_state_dict is the inverse (the reference
layout of a port model's weights), which the tests and chip_smoke.py use
to write a checkpoint.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Mapping, Tuple

import torch

from .wan_vae import WanVAEConfig, WanVideoVAE


def _conv3d(sd, key, out, ours):
    out[f"{ours}.weight"], out[f"{ours}.bias"] = sd[f"{key}.weight"], sd[f"{key}.bias"]


def _rms(sd, key, out, ours):
    out[f"{ours}.gamma"] = sd[f"{key}.gamma"].reshape(-1)


def _res_block(sd, prefix, out, ours):
    _rms(sd, f"{prefix}.residual.0", out, f"{ours}.norm1")
    _conv3d(sd, f"{prefix}.residual.2", out, f"{ours}.conv1.conv")
    _rms(sd, f"{prefix}.residual.3", out, f"{ours}.norm2")
    _conv3d(sd, f"{prefix}.residual.6", out, f"{ours}.conv2.conv")
    if f"{prefix}.shortcut.weight" in sd:
        _conv3d(sd, f"{prefix}.shortcut", out, f"{ours}.shortcut.conv")


def _attn_block(sd, prefix, out, ours):
    _rms(sd, f"{prefix}.norm", out, f"{ours}.norm")
    for name in ("to_qkv", "proj"):  # 1x1 Conv2d [O, I, 1, 1] -> Linear [O, I]
        out[f"{ours}.{name}.weight"] = sd[f"{prefix}.{name}.weight"][..., 0, 0]
        out[f"{ours}.{name}.bias"] = sd[f"{prefix}.{name}.bias"]


def _layout(cfg: WanVAEConfig) -> Iterator[Tuple[str, str, str]]:
    """(kind, reference prefix, port prefix) of every module with weights,
    replaying the reference's construction loops (kind: conv, res, attn,
    rms)."""
    for part in ("encoder", "decoder"):
        yield "conv", f"{part}.conv1", f"{part}.conv1.conv"
        yield "res", f"{part}.middle.0", f"{part}.mid_res_0"
        yield "attn", f"{part}.middle.1", f"{part}.mid_attn"
        yield "res", f"{part}.middle.2", f"{part}.mid_res_1"
        yield "rms", f"{part}.head.0", f"{part}.head_norm"
        yield "conv", f"{part}.head.2", f"{part}.head_conv.conv"
    n_stages = len(cfg.dim_mult)
    seq = li = 0
    scale = 1.0
    for i in range(n_stages):
        for _ in range(cfg.num_res_blocks):
            yield "res", f"encoder.downsamples.{seq}", f"encoder.down_{li}"
            seq += 1
            li += 1
            if scale in cfg.attn_scales:
                yield "attn", f"encoder.downsamples.{seq}", f"encoder.down_{li}"
                seq += 1
                li += 1
        if i != n_stages - 1:
            base = f"encoder.downsamples.{seq}"
            yield "conv", f"{base}.resample.1", f"encoder.down_{li}_s.conv"
            if cfg.temperal_downsample[i]:
                yield "conv", f"{base}.time_conv", f"encoder.down_{li}_t.time_conv"
            seq += 1
            li += 1
            scale /= 2.0
    temperal_upsample = tuple(reversed(cfg.temperal_downsample))
    seq = li = 0
    for i in range(n_stages):
        for _ in range(cfg.num_res_blocks + 1):
            yield "res", f"decoder.upsamples.{seq}", f"decoder.up_{li}"
            seq += 1
            li += 1
        if i != n_stages - 1:
            base = f"decoder.upsamples.{seq}"
            if temperal_upsample[i]:
                yield "conv", f"{base}.time_conv", f"decoder.up_{li}_t.time_conv"
            yield "conv", f"{base}.resample.1", f"decoder.up_{li}_s.conv"
            seq += 1
            li += 1
    yield "conv", "conv1", "conv1_quant.conv"
    yield "conv", "conv2", "post_quant_conv.conv"


_CONVERTERS = {"conv": _conv3d, "res": _res_block, "attn": _attn_block, "rms": _rms}

# diffusers' AutoencoderKLWan / AutoencoderKLQwenImage (Qwen-Image's VAE):
# the same modules under other names. Leaves of each kind, reference ->
# diffusers, and the fixed module prefixes.
_DIFFUSERS_LEAVES = {
    "conv": (("weight", "weight"), ("bias", "bias")),
    "rms": (("gamma", "gamma"),),
    "attn": tuple((f"{m}.{leaf}", f"{m}.{leaf}") for m, leaf in (
        ("norm", "gamma"), ("to_qkv", "weight"), ("to_qkv", "bias"), ("proj", "weight"),
        ("proj", "bias"))),
    "res": (("residual.0.gamma", "norm1.gamma"), ("residual.2.weight", "conv1.weight"),
            ("residual.2.bias", "conv1.bias"), ("residual.3.gamma", "norm2.gamma"),
            ("residual.6.weight", "conv2.weight"), ("residual.6.bias", "conv2.bias"),
            ("shortcut.weight", "conv_shortcut.weight"), ("shortcut.bias", "conv_shortcut.bias")),
}
_DIFFUSERS_FIXED = {"conv1": "quant_conv", "conv2": "post_quant_conv"}
for _part in ("encoder", "decoder"):
    _DIFFUSERS_FIXED.update({
        f"{_part}.conv1": f"{_part}.conv_in", f"{_part}.head.0": f"{_part}.norm_out",
        f"{_part}.head.2": f"{_part}.conv_out",
        f"{_part}.middle.0": f"{_part}.mid_block.resnets.0",
        f"{_part}.middle.1": f"{_part}.mid_block.attentions.0",
        f"{_part}.middle.2": f"{_part}.mid_block.resnets.1"})


def diffusers_key_map(cfg: WanVAEConfig) -> Dict[str, str]:
    """reference key -> diffusers key of every tensor of a Wan 2.1 VAE of
    `cfg`: the encoder's flat `downsamples.N` are `down_blocks.N`, the
    decoder's flat `upsamples.N` split into `up_blocks.i.resnets.j` and
    `up_blocks.i.upsamplers.0`, a residual block's Sequential indices
    become norm1 / conv1 / norm2 / conv2 / conv_shortcut."""
    import re

    up, seq = {}, 0
    for i in range(len(cfg.dim_mult)):
        for j in range(cfg.num_res_blocks + 1):
            up[seq], seq = f"decoder.up_blocks.{i}.resnets.{j}", seq + 1
        if i != len(cfg.dim_mult) - 1:
            up[seq], seq = f"decoder.up_blocks.{i}.upsamplers.0", seq + 1

    def prefix(theirs: str) -> str:
        if theirs in _DIFFUSERS_FIXED:
            return _DIFFUSERS_FIXED[theirs]
        m = re.match(r"encoder\.downsamples\.(\d+)(.*)$", theirs)
        if m:
            return f"encoder.down_blocks.{m[1]}{m[2]}"
        m = re.match(r"decoder\.upsamples\.(\d+)(.*)$", theirs)
        return f"{up[int(m[1])]}{m[2]}"

    return {f"{theirs}.{a}": f"{prefix(theirs)}.{b}"
            for kind, theirs, _ in _layout(cfg) for a, b in _DIFFUSERS_LEAVES[kind]}


def from_diffusers_layout(sd: Mapping[str, torch.Tensor],
                          cfg: WanVAEConfig) -> Dict[str, torch.Tensor]:
    """A diffusers-layout Wan 2.1 / Qwen-Image VAE state dict in the
    reference layout (a key outside the map raises KeyError)."""
    inv = {d: r for r, d in diffusers_key_map(cfg).items()}
    extra = [k for k in sd if k not in inv]
    if extra:
        raise KeyError(f"VAE keys outside the diffusers Wan layout: {extra[:5]}")
    return {inv[k]: v for k, v in sd.items()}


def is_diffusers_layout(sd: Mapping[str, torch.Tensor]) -> bool:
    return any(k.startswith(("encoder.conv_in.", "encoder.down_blocks.")) for k in sd)


def convert_layout(sd: Mapping[str, torch.Tensor], layout) -> Dict[str, torch.Tensor]:
    """A reference-layout state dict -> the port's, along `layout`."""
    sd = {k.removeprefix("vae.").removeprefix("model."): v for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    for kind, theirs, ours in layout:
        _CONVERTERS[kind](sd, theirs, out, ours)
    return out


def convert_wan_vae(sd: Mapping[str, torch.Tensor], cfg: WanVAEConfig) -> Dict[str, torch.Tensor]:
    """A reference-layout Wan 2.1 VAE state dict -> the port's state dict."""
    return convert_layout(sd, _layout(cfg))


def wan_vae_state_dict(vae: WanVideoVAE) -> Dict[str, torch.Tensor]:
    """The port model's weights in the reference layout (the inverse of
    convert_wan_vae, or of convert_wan22_vae for a WanVideoVAE22): RMS
    gammas [C, 1, 1, 1] (the 2-D attention's [C, 1, 1]), attention linears
    as 1x1 Conv2d weights."""
    ours_sd = {k: v.detach() for k, v in vae.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}

    def put_conv(theirs, ours):
        out[f"{theirs}.weight"] = ours_sd[f"{ours}.weight"]
        out[f"{theirs}.bias"] = ours_sd[f"{ours}.bias"]

    def put_rms(theirs, ours, dims=3):
        out[f"{theirs}.gamma"] = ours_sd[f"{ours}.gamma"].reshape((-1,) + (1,) * dims)

    for kind, theirs, ours in vae.checkpoint_layout():
        if kind == "conv":
            put_conv(theirs, ours)
        elif kind == "rms":
            put_rms(theirs, ours)
        elif kind == "attn":
            put_rms(f"{theirs}.norm", f"{ours}.norm", dims=2)
            for name in ("to_qkv", "proj"):
                out[f"{theirs}.{name}.weight"] = ours_sd[f"{ours}.{name}.weight"][..., None, None]
                out[f"{theirs}.{name}.bias"] = ours_sd[f"{ours}.{name}.bias"]
        else:
            put_rms(f"{theirs}.residual.0", f"{ours}.norm1")
            put_conv(f"{theirs}.residual.2", f"{ours}.conv1.conv")
            put_rms(f"{theirs}.residual.3", f"{ours}.norm2")
            put_conv(f"{theirs}.residual.6", f"{ours}.conv2.conv")
            if f"{ours}.shortcut.conv.weight" in ours_sd:
                put_conv(f"{theirs}.shortcut", f"{ours}.shortcut.conv")
    return out


def load_vae_checkpoint(cls, cfg, state_dict: Mapping[str, torch.Tensor], device=None):
    """cls(cfg) on `device` (default the CPU) with exactly `state_dict`'s
    weights, cast to cfg.dtype, frozen in eval mode; a key missing or
    extra raises (the JAX loader's structural check)."""
    with torch.device("meta"):
        vae = cls(cfg)
    vae = vae.to_empty(device=device or "cpu")
    vae.load_state_dict({k: v.to(cfg.dtype) for k, v in state_dict.items()})
    return vae.eval().requires_grad_(False)


def load_wan_vae(path, dtype: torch.dtype = torch.float32, device=None) -> WanVideoVAE:
    """The Wan 2.1 VAE from a .pth / .pt / .bin or safetensors checkpoint,
    or a folder of safetensors (a diffusers `vae/` folder), in the
    reference or the diffusers layout, in `dtype` on `device` (default the
    CPU), frozen."""
    from .weights import load_state_dict_any

    cfg = WanVAEConfig.wan21(dtype=dtype)
    sd = load_state_dict_any(Path(path))
    if is_diffusers_layout(sd):
        sd = from_diffusers_layout(sd, cfg)
    return load_vae_checkpoint(WanVideoVAE, cfg, convert_wan_vae(sd, cfg), device)
