"""SDXL weight conversion and export.

Counterpart of diffusion_pipe_tpu/models/sdxl_convert.py:
- convert_diffusers_sdxl_unet / export_sdxl_unet_diffusers: a diffusers
  UNet2DConditionModel state dict <-> the port's SDXLUNet names. Both sides
  are torch layouts, so only the names change;
- export_sdxl_lora_kohya: the trained LoRA (or LoKr) factors under kohya
  sd-scripts keys, lora_unet_<module path with _>.lora_{down,up}.weight and
  .alpha, in the JAX export's order and bits;
- convert_sd_unet_to_diffusers / convert_diffusers_unet_to_sd: the original
  SD single-file UNet keys <-> diffusers keys;
- convert_hf_clip_to_openclip: transformers' CLIP text keys -> OpenCLIP's,
  q / k / v fused into in_proj;
- convert_diffusers_vae_keys_to_sd: diffusers AutoencoderKL keys -> the
  original SD first_stage_model keys.
The JAX flax_hf_to_torch_sd has no counterpart here: the port's CLIP towers
already hold transformers' torch keys (interop.tree_to_state_dict carries
the Flax parameters across).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import torch

from .sdxl_unet import SDXLConfig

_BLOCK_LINEARS = {  # port name -> diffusers module, in a BasicTransformerBlock
    "attn1_to_q": "attn1.to_q", "attn1_to_k": "attn1.to_k", "attn1_to_v": "attn1.to_v",
    "attn1_to_out": "attn1.to_out.0",
    "attn2_to_q": "attn2.to_q", "attn2_to_k": "attn2.to_k", "attn2_to_v": "attn2.to_v",
    "attn2_to_out": "attn2.to_out.0",
    "ff_proj": "ff.net.0.proj", "ff_out": "ff.net.2",
}
_NO_BIAS = ("to_q", "to_k", "to_v")


def _wb(ours: str, theirs: str, bias: bool = True) -> Iterator[Tuple[str, str]]:
    yield f"{ours}.weight", f"{theirs}.weight"
    if bias:
        yield f"{ours}.bias", f"{theirs}.bias"


def _resnet(ours, theirs, has_shortcut):
    for name in ("norm1", "conv1", "time_emb_proj", "norm2", "conv2"):
        yield from _wb(f"{ours}.{name}", f"{theirs}.{name}")
    if has_shortcut:
        yield from _wb(f"{ours}.conv_shortcut", f"{theirs}.conv_shortcut")


def _transformer(ours, theirs, depth):
    for name in ("norm", "proj_in", "proj_out"):
        yield from _wb(f"{ours}.{name}", f"{theirs}.{name}")
    for i in range(depth):
        po, pt = f"{ours}.blocks.{i}", f"{theirs}.transformer_blocks.{i}"
        for k in (1, 2, 3):
            yield from _wb(f"{po}.norm{k}", f"{pt}.norm{k}")
        for mine, module in _BLOCK_LINEARS.items():
            yield from _wb(f"{po}.{mine}", f"{pt}.{module}", not mine.endswith(_NO_BIAS))


def _unet_name_pairs(cfg: SDXLConfig):
    """(port name, diffusers key) of every UNet parameter, in the JAX
    export's order."""
    yield from _wb("conv_in", "conv_in")
    for name in ("time_embedding", "add_embedding"):
        for j in (1, 2):
            yield from _wb(f"{name}_{j}", f"{name}.linear_{j}")
    yield from _wb("conv_norm_out", "conv_norm_out")
    yield from _wb("conv_out", "conv_out")
    chs = cfg.block_out_channels
    n = len(chs)
    cin = chs[0]
    for i, ch in enumerate(chs):
        depth = cfg.transformer_layers[i]
        for j in range(cfg.layers_per_block):
            yield from _resnet(f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}", cin != ch)
            cin = ch
            if depth > 0:
                yield from _transformer(f"down_{i}_attn_{j}",
                                        f"down_blocks.{i}.attentions.{j}", depth)
        if i < n - 1:
            yield from _wb(f"down_{i}_downsample", f"down_blocks.{i}.downsamplers.0.conv")
    yield from _resnet("mid_res_0", "mid_block.resnets.0", False)
    yield from _resnet("mid_res_1", "mid_block.resnets.1", False)
    yield from _transformer("mid_attn", "mid_block.attentions.0", cfg.transformer_layers[-1])
    rev_depths = list(reversed(cfg.transformer_layers))
    # the up resnets always change their width (skip concatenation)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            yield from _resnet(f"up_{i}_res_{j}", f"up_blocks.{i}.resnets.{j}", True)
            if rev_depths[i] > 0:
                yield from _transformer(f"up_{i}_attn_{j}", f"up_blocks.{i}.attentions.{j}",
                                        rev_depths[i])
        if i < n - 1:
            yield from _wb(f"up_{i}_upsample", f"up_blocks.{i}.upsamplers.0.conv")


def convert_diffusers_sdxl_unet(sd: Mapping[str, torch.Tensor],
                                cfg: SDXLConfig) -> Dict[str, torch.Tensor]:
    """A diffusers SDXL UNet state dict -> SDXLUNet's (pretrained tensors
    only: adapter factors keep their initialisation when it is loaded). A
    key missing or left over raises KeyError naming it."""
    from .weights import take

    return take(sd, _unet_name_pairs(cfg), "SDXL UNet checkpoint")


def export_sdxl_unet_diffusers(unet_sd: Mapping[str, torch.Tensor],
                               cfg: SDXLConfig) -> Dict[str, torch.Tensor]:
    """SDXLUNet's state dict -> diffusers keys (the inverse of
    convert_diffusers_sdxl_unet)."""
    return {theirs: unet_sd[ours] for ours, theirs in _unet_name_pairs(cfg)}


# --- kohya LoRA export ------------------------------------------------------

_KOHYA = {  # port name -> kohya module suffix
    "attn1_to_q": "attn1_to_q", "attn1_to_k": "attn1_to_k",
    "attn1_to_v": "attn1_to_v", "attn1_to_out": "attn1_to_out_0",
    "attn2_to_q": "attn2_to_q", "attn2_to_k": "attn2_to_k",
    "attn2_to_v": "attn2_to_v", "attn2_to_out": "attn2_to_out_0",
    "ff_proj": "ff_net_0_proj", "ff_out": "ff_net_2",
}
_LOKR_LEAVES = ("lokr_w1", "lokr_w2", "lokr_w2_a", "lokr_w2_b")


def _transformers_in_order(cfg: SDXLConfig):
    """(port module, kohya prefix, depth) of every transformer, down, mid,
    up."""
    n = len(cfg.block_out_channels)
    for i in range(n):
        for j in range(cfg.layers_per_block):
            if cfg.transformer_layers[i] > 0:
                yield (f"down_{i}_attn_{j}", f"down_blocks_{i}_attentions_{j}",
                       cfg.transformer_layers[i])
    yield "mid_attn", "mid_block_attentions_0", cfg.transformer_layers[-1]
    rev = list(reversed(cfg.transformer_layers))
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            if rev[i] > 0:
                yield f"up_{i}_attn_{j}", f"up_blocks_{i}_attentions_{j}", rev[i]


def export_sdxl_lora_kohya(trainable: Mapping[str, torch.Tensor],
                           cfg: SDXLConfig) -> Dict[str, torch.Tensor]:
    """Adapter factors (SDXLModel's names, under `unet.`) -> kohya keys:
    lora_unet_<module>.lora_down.weight (lora_a [in, r] transposed),
    .lora_up.weight (lora_b [r, out] transposed) and .alpha (0-dim f32);
    LoKr factors as lycoris_unet_<module>.<factor> (transposed) and
    .alpha. f32, in the JAX export's order."""
    out: Dict[str, torch.Tensor] = {}
    alpha = torch.tensor(float(cfg.lora_alpha), dtype=torch.float32)

    def t(name):
        return trainable[name].detach().float().t().contiguous().cpu()

    for ours, kohya_prefix, depth in _transformers_in_order(cfg):
        for i in range(depth):
            for mine, kohya in _KOHYA.items():
                leaf = f"unet.{ours}.blocks.{i}.{mine}"
                mod = f"{kohya_prefix}_transformer_blocks_{i}_{kohya}"
                if f"{leaf}.lora_a" in trainable:
                    out[f"lora_unet_{mod}.lora_down.weight"] = t(f"{leaf}.lora_a")
                    out[f"lora_unet_{mod}.lora_up.weight"] = t(f"{leaf}.lora_b")
                    out[f"lora_unet_{mod}.alpha"] = alpha.clone()
                lokr = [name for name in _LOKR_LEAVES if f"{leaf}.{name}" in trainable]
                for name in lokr:
                    out[f"lycoris_unet_{mod}.{name}"] = t(f"{leaf}.{name}")
                if lokr:
                    out[f"lycoris_unet_{mod}.alpha"] = alpha.clone()
    return out


# --- original SD (single-file) UNet keys -----------------------------------

SD_HF_TOP = [
    ("time_embed.0.weight", "time_embedding.linear_1.weight"),
    ("time_embed.0.bias", "time_embedding.linear_1.bias"),
    ("time_embed.2.weight", "time_embedding.linear_2.weight"),
    ("time_embed.2.bias", "time_embedding.linear_2.bias"),
    ("input_blocks.0.0.weight", "conv_in.weight"),
    ("input_blocks.0.0.bias", "conv_in.bias"),
    ("out.0.weight", "conv_norm_out.weight"),
    ("out.0.bias", "conv_norm_out.bias"),
    ("out.2.weight", "conv_out.weight"),
    ("out.2.bias", "conv_out.bias"),
    ("label_emb.0.0.weight", "add_embedding.linear_1.weight"),
    ("label_emb.0.0.bias", "add_embedding.linear_1.bias"),
    ("label_emb.0.2.weight", "add_embedding.linear_2.weight"),
    ("label_emb.0.2.bias", "add_embedding.linear_2.bias"),
]
SD_HF_RESNET = [
    ("in_layers.0", "norm1"),
    ("in_layers.2", "conv1"),
    ("out_layers.0", "norm2"),
    ("out_layers.3", "conv2"),
    ("emb_layers.1", "time_emb_proj"),
    ("skip_connection", "conv_shortcut"),
]


def _sd_hf_layer_map():
    """(sd prefix, diffusers prefix) pairs. SDXL's up stages have three
    resnets; up stage 0's upsampler shares output_blocks.2 with attention
    2, at .2.conv."""
    m = []
    for i in range(3):
        for j in range(2):
            m.append((f"input_blocks.{3*i + j + 1}.0.", f"down_blocks.{i}.resnets.{j}."))
            if i > 0:
                m.append((f"input_blocks.{3*i + j + 1}.1.", f"down_blocks.{i}.attentions.{j}."))
        for j in range(3):
            m.append((f"output_blocks.{3*i + j}.0.", f"up_blocks.{i}.resnets.{j}."))
            if i < 2:
                m.append((f"output_blocks.{3*i + j}.1.", f"up_blocks.{i}.attentions.{j}."))
        if i < 2:
            m.append((f"input_blocks.{3*(i+1)}.0.op.", f"down_blocks.{i}.downsamplers.0.conv."))
    m.append(("output_blocks.2.2.conv.", "up_blocks.0.upsamplers.0.conv."))
    m.append(("output_blocks.5.2.", "up_blocks.1.upsamplers.0."))
    m.append(("middle_block.1.", "mid_block.attentions.0."))
    for j in range(2):
        m.append((f"middle_block.{2*j}.", f"mid_block.resnets.{j}."))
    return m


def convert_sd_unet_to_diffusers(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Original SD-format SDXL UNet keys (optionally under
    model.diffusion_model.; the VAE and text encoders of a single file
    dropped) -> diffusers keys."""
    sd = {k.removeprefix("model.diffusion_model."): v for k, v in sd.items()
          if "diffusion_model" in k or not k.startswith(("first_stage_model.", "conditioner."))}
    top = dict(SD_HF_TOP)
    layer = sorted(_sd_hf_layer_map(), key=lambda kv: -len(kv[0]))
    out = {}
    for k, v in sd.items():
        if k in top:
            out[top[k]] = v
            continue
        nk = k
        for sd_p, hf_p in layer:
            if nk.startswith(sd_p):
                nk = hf_p + nk[len(sd_p):]
                break
        if "resnets" in nk:
            for sd_p, hf_p in SD_HF_RESNET:
                nk = nk.replace(sd_p, hf_p)
        out[nk] = v
    return out


def convert_diffusers_unet_to_sd(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """diffusers SDXL UNet keys -> original SD-format keys."""
    top = {hf: s for s, hf in SD_HF_TOP}
    layer = sorted(_sd_hf_layer_map(), key=lambda kv: -len(kv[1]))
    out = {}
    for k, v in sd.items():
        if k in top:
            out[top[k]] = v
            continue
        nk = k
        if "resnets" in nk:
            for sd_p, hf_p in SD_HF_RESNET:
                nk = nk.replace(hf_p, sd_p)
        for sd_p, hf_p in layer:
            if nk.startswith(hf_p):
                nk = sd_p + nk[len(hf_p):]
                break
        out[nk] = v
    return out


# --- text encoders and VAE in the single file ---------------------------------

_OPENCLIP_RENAMES = [  # (OpenCLIP, transformers)
    ("transformer.resblocks.", "text_model.encoder.layers."),
    ("ln_1", "layer_norm1"),
    ("ln_2", "layer_norm2"),
    (".c_fc.", ".fc1."),
    (".c_proj.", ".fc2."),
    (".attn", ".self_attn"),
    ("ln_final.", "text_model.final_layer_norm."),
    ("token_embedding.weight", "text_model.embeddings.token_embedding.weight"),
    ("positional_embedding", "text_model.embeddings.position_embedding.weight"),
]


def convert_hf_clip_to_openclip(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """transformers CLIP text keys -> OpenCLIP keys, each layer's q / k / v
    weights and biases concatenated into in_proj_weight / in_proj_bias."""
    def rename(k):
        for sd_part, hf_part in _OPENCLIP_RENAMES:
            k = k.replace(hf_part, sd_part)
        return k

    out: Dict[str, torch.Tensor] = {}
    fused: Dict[Tuple[str, str], list] = {}
    for k, v in sd.items():
        for c, idx in (("q", 0), ("k", 1), ("v", 2)):
            kind = next((kd for kd in ("weight", "bias")
                         if k.endswith(f".self_attn.{c}_proj.{kd}")), None)
            if kind is not None:
                pre = k[: -len(f".{c}_proj.{kind}")]
                fused.setdefault((pre, kind), [None, None, None])[idx] = v
                break
        else:
            out[rename(k)] = v
    for (pre, kind), parts in sorted(fused.items(), key=lambda kv: kv[0][1] == "bias"):
        if any(p is None for p in parts):
            raise KeyError(f"{pre}: q, k and v {kind} are not all present")
        out[rename(pre) + f".in_proj_{kind}"] = torch.cat(parts, dim=0)
    return out


def convert_diffusers_vae_keys_to_sd(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """diffusers AutoencoderKL keys -> the original SD first_stage_model
    keys; the mid-block attention's q / k / v / proj_out weights become
    1 x 1 convolutions [O, I, 1, 1]."""
    renames = [("nin_shortcut", "conv_shortcut"), ("norm_out", "conv_norm_out"),
               ("mid.attn_1.", "mid_block.attentions.0.")]
    for i in range(4):
        for j in range(2):
            renames.append((f"encoder.down.{i}.block.{j}.", f"encoder.down_blocks.{i}.resnets.{j}."))
        if i < 3:
            renames.append((f"down.{i}.downsample.", f"down_blocks.{i}.downsamplers.0."))
            renames.append((f"up.{3-i}.upsample.", f"up_blocks.{i}.upsamplers.0."))
        for j in range(3):
            renames.append((f"decoder.up.{3-i}.block.{j}.", f"decoder.up_blocks.{i}.resnets.{j}."))
    for i in range(2):
        renames.append((f"mid.block_{i+1}.", f"mid_block.resnets.{i}."))
    attn_renames = [("norm.", "group_norm."), ("q.", "to_q."), ("k.", "to_k."),
                    ("v.", "to_v."), ("proj_out.", "to_out.0.")]
    out = {}
    for k, v in sd.items():
        nk = k
        for sd_part, hf_part in renames:
            nk = nk.replace(hf_part, sd_part)
        if "attn_1" in nk or "attentions" in k:
            for sd_part, hf_part in attn_renames:
                nk = nk.replace(hf_part, sd_part)
        if any(f"mid.attn_1.{w}.weight" in nk for w in ("q", "k", "v", "proj_out")) and v.dim() == 2:
            v = v.reshape(*v.shape, 1, 1)
        out[nk] = v
    return out
