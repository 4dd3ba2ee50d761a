"""Flux weight conversion: diffusers and BFL checkpoints onto the port's
FluxTransformer, and LoRA export and import in the diffusers format.

Counterpart of diffusion_pipe_tpu/models/flux_convert.py. The port keeps
torch's [out, in] layout, so a diffusers checkpoint maps by name alone:

  transformer_blocks.{i}.<diffusers path>        -> double_blocks.{i}.<ours>
  single_transformer_blocks.{i}.<diffusers path> -> single_blocks.{i}.<ours>
  <norm>.weight (RMSNorm)                        -> <ours>.scale

with the block maps below, and the top-level embedders, norm_out.linear ->
norm_out_linear and proj_out. An exported adapter holds, for every LoRA
linear, transformer.<diffusers path>.lora_A.weight [r, in] and
.lora_B.weight [r, out]^T = [out, r] in f32 (LoKr: .lokr_w1 and .lokr_w2 or
.lokr_w2_a / .lokr_w2_b, each transposed): the same keys and bits as the
JAX package's export of the same factors.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from .flux_model import FluxConfig

_DOUBLE_MAP = {
    "norm1_linear": "norm1.linear",
    "norm1_context_linear": "norm1_context.linear",
    "attn_to_q": "attn.to_q",
    "attn_to_k": "attn.to_k",
    "attn_to_v": "attn.to_v",
    "attn_add_q": "attn.add_q_proj",
    "attn_add_k": "attn.add_k_proj",
    "attn_add_v": "attn.add_v_proj",
    "attn_to_out": "attn.to_out.0",
    "attn_to_add_out": "attn.to_add_out",
    "ff_in": "ff.net.0.proj",
    "ff_out": "ff.net.2",
    "ff_context_in": "ff_context.net.0.proj",
    "ff_context_out": "ff_context.net.2",
}
_DOUBLE_NORMS = {
    "attn_norm_q": "attn.norm_q",
    "attn_norm_k": "attn.norm_k",
    "attn_norm_added_q": "attn.norm_added_q",
    "attn_norm_added_k": "attn.norm_added_k",
}
_SINGLE_MAP = {
    "norm_linear": "norm.linear",
    "attn_to_q": "attn.to_q",
    "attn_to_k": "attn.to_k",
    "attn_to_v": "attn.to_v",
    "proj_mlp": "proj_mlp",
    "proj_out": "proj_out",
}
_SINGLE_NORMS = {"attn_norm_q": "attn.norm_q", "attn_norm_k": "attn.norm_k"}
_TOP = {
    "x_embedder": "x_embedder",
    "context_embedder": "context_embedder",
    "timestep_embedder.linear_1": "time_text_embed.timestep_embedder.linear_1",
    "timestep_embedder.linear_2": "time_text_embed.timestep_embedder.linear_2",
    "text_embedder.linear_1": "time_text_embed.text_embedder.linear_1",
    "text_embedder.linear_2": "time_text_embed.text_embedder.linear_2",
    "norm_out_linear": "norm_out.linear",
    "proj_out": "proj_out",
}
_GUIDANCE = {
    "guidance_embedder.linear_1": "time_text_embed.guidance_embedder.linear_1",
    "guidance_embedder.linear_2": "time_text_embed.guidance_embedder.linear_2",
}


def _block_groups(config: FluxConfig):
    """(our prefix, diffusers prefix, linear map, norm map) of every block."""
    for i in range(config.num_layers):
        yield f"double_blocks.{i}", f"transformer_blocks.{i}", _DOUBLE_MAP, _DOUBLE_NORMS
    for i in range(config.num_single_layers):
        yield (f"single_blocks.{i}", f"single_transformer_blocks.{i}", _SINGLE_MAP,
               _SINGLE_NORMS)


def convert_diffusers_flux(sd: Mapping[str, torch.Tensor],
                           config: FluxConfig) -> Dict[str, torch.Tensor]:
    """A diffusers FluxTransformer2DModel state dict -> the port's state
    dict (pretrained tensors only: the LoRA factors and int8 scales keep
    their initialisation when it is loaded). A key missing or left over
    raises KeyError naming it."""
    from .weights import TrackedDict

    sd = TrackedDict(sd, "Flux checkpoint")
    out: Dict[str, torch.Tensor] = {}

    def linear(ours, theirs):
        out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
        if f"{theirs}.bias" in sd:
            out[f"{ours}.bias"] = sd[f"{theirs}.bias"]

    top = dict(_TOP, **(_GUIDANCE if config.guidance_embeds else {}))
    for ours, theirs in top.items():
        linear(ours, theirs)
    for ours_p, theirs_p, lin_map, norm_map in _block_groups(config):
        for ours, theirs in lin_map.items():
            linear(f"{ours_p}.{ours}", f"{theirs_p}.{theirs}")
        for ours, theirs in norm_map.items():
            out[f"{ours_p}.{ours}.scale"] = sd[f"{theirs_p}.{theirs}.weight"]
    sd.check_all_read()
    return out


# adapter factors: ours (the Flax layouts, e.g. [in, r] / [r, out]) ->
# diffusers-lora names, transposed; the LoKr factors keep their names
# (PEFT LoKrLayer's, torch [out, in] orientation)
_LORA_LEAVES = {"lora_a": "lora_A.weight", "lora_b": "lora_B.weight",
                **{k: k for k in ("lokr_w1", "lokr_w2", "lokr_w2_a", "lokr_w2_b")}}


def export_lora_diffusers(trainable: Mapping[str, torch.Tensor],
                          config: FluxConfig) -> Dict[str, torch.Tensor]:
    """The trainable adapter factors (port names) -> a diffusers-lora state
    dict: transformer.<diffusers path>.lora_A.weight (our lora_a [in, r]
    transposed) and .lora_B.weight (lora_b [r, out] transposed), or the LoKr
    factors .lokr_w1 / .lokr_w2 / .lokr_w2_a / .lokr_w2_b transposed, f32."""
    out: Dict[str, torch.Tensor] = {}
    for ours_p, theirs_p, lin_map, _ in _block_groups(config):
        for ours, theirs in lin_map.items():
            key = f"{ours_p}.{ours}"
            dst = f"transformer.{theirs_p}.{theirs}"
            for leaf, theirs_leaf in _LORA_LEAVES.items():
                if f"{key}.{leaf}" in trainable:
                    out[f"{dst}.{theirs_leaf}"] = (
                        trainable[f"{key}.{leaf}"].detach().float().t().contiguous().cpu())
    return out


def import_lora_diffusers(sd: Mapping[str, torch.Tensor],
                          config: FluxConfig) -> Dict[str, torch.Tensor]:
    """The inverse of export_lora_diffusers, for `adapter.init_from_existing`:
    the adapter factors (port names, [in, r] / [r, out]) of every linear the
    file holds keys for (diffusers `transformer.` or ComfyUI
    `diffusion_model.` prefix). Load the result over an initialised model:
    factors without a key keep their initialisation."""
    sd = {re.sub(r"^(transformer|diffusion_model)\.", "", k): v for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    for ours_p, theirs_p, lin_map, _ in _block_groups(config):
        for ours, theirs in lin_map.items():
            for leaf, their_leaf in _LORA_LEAVES.items():
                k = f"{theirs_p}.{theirs}.{their_leaf}"
                if k in sd:  # saved in torch [out, in] orientation
                    out[f"{ours_p}.{ours}.{leaf}"] = sd[k].float().t().contiguous()
    if not out:
        raise RuntimeError("init_from_existing: no LoRA keys in the file matched this model")
    return out


def convert_bfl_flux(sd: Mapping[str, torch.Tensor],
                     config: FluxConfig) -> Dict[str, torch.Tensor]:
    """A BFL single-file Flux checkpoint -> the port's state dict: the fused
    double-block qkv splits into to_q/k/v (and add_*), the single-block
    linear1 into qkv and proj_mlp, the final adaLN's (shift, scale) halves
    swap into diffusers' (scale, shift), the embedders are renamed, then
    convert_diffusers_flux applies. A BFL key left over raises KeyError
    naming it (a missing one, in its diffusers name)."""
    from .weights import TrackedDict

    sd = TrackedDict(sd, "Flux (BFL) checkpoint")
    d: Dict[str, torch.Tensor] = {}
    h = config.hidden_size

    def put(dst, src_key):
        if src_key in sd:
            d[dst] = sd[src_key]

    top = {
        "time_in.in_layer": "time_text_embed.timestep_embedder.linear_1",
        "time_in.out_layer": "time_text_embed.timestep_embedder.linear_2",
        "vector_in.in_layer": "time_text_embed.text_embedder.linear_1",
        "vector_in.out_layer": "time_text_embed.text_embedder.linear_2",
        "guidance_in.in_layer": "time_text_embed.guidance_embedder.linear_1",
        "guidance_in.out_layer": "time_text_embed.guidance_embedder.linear_2",
        "txt_in": "context_embedder",
        "img_in": "x_embedder",
        "final_layer.linear": "proj_out",
    }
    for bfl, diff in top.items():
        put(f"{diff}.weight", f"{bfl}.weight")
        put(f"{diff}.bias", f"{bfl}.bias")
    w = sd["final_layer.adaLN_modulation.1.weight"]
    b = sd["final_layer.adaLN_modulation.1.bias"]
    d["norm_out.linear.weight"] = torch.cat([w[h:], w[:h]], dim=0)
    d["norm_out.linear.bias"] = torch.cat([b[h:], b[:h]], dim=0)

    def split(key, names, prefix, sizes):
        for suffix in ("weight", "bias"):
            if f"{key}.{suffix}" in sd:
                for n, part in zip(names, sd[f"{key}.{suffix}"].split(sizes, dim=0)):
                    d[f"{prefix}.{n}.{suffix}"] = part

    for i in range(config.num_layers):
        bp, dp = f"double_blocks.{i}", f"transformer_blocks.{i}"
        pairs = {
            "img_mod.lin": "norm1.linear",
            "txt_mod.lin": "norm1_context.linear",
            "img_attn.proj": "attn.to_out.0",
            "txt_attn.proj": "attn.to_add_out",
            "img_mlp.0": "ff.net.0.proj",
            "img_mlp.2": "ff.net.2",
            "txt_mlp.0": "ff_context.net.0.proj",
            "txt_mlp.2": "ff_context.net.2",
        }
        for bfl, diff in pairs.items():
            put(f"{dp}.{diff}.weight", f"{bp}.{bfl}.weight")
            put(f"{dp}.{diff}.bias", f"{bp}.{bfl}.bias")
        split(f"{bp}.img_attn.qkv", ["attn.to_q", "attn.to_k", "attn.to_v"], dp, h)
        split(f"{bp}.txt_attn.qkv", ["attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj"],
              dp, h)
        norms = {
            "img_attn.norm.query_norm.scale": "attn.norm_q.weight",
            "img_attn.norm.key_norm.scale": "attn.norm_k.weight",
            "txt_attn.norm.query_norm.scale": "attn.norm_added_q.weight",
            "txt_attn.norm.key_norm.scale": "attn.norm_added_k.weight",
        }
        for bfl, diff in norms.items():
            put(f"{dp}.{diff}", f"{bp}.{bfl}")

    for i in range(config.num_single_layers):
        bp, dp = f"single_blocks.{i}", f"single_transformer_blocks.{i}"
        put(f"{dp}.norm.linear.weight", f"{bp}.modulation.lin.weight")
        put(f"{dp}.norm.linear.bias", f"{bp}.modulation.lin.bias")
        put(f"{dp}.proj_out.weight", f"{bp}.linear2.weight")
        put(f"{dp}.proj_out.bias", f"{bp}.linear2.bias")
        put(f"{dp}.attn.norm_q.weight", f"{bp}.norm.query_norm.scale")
        put(f"{dp}.attn.norm_k.weight", f"{bp}.norm.key_norm.scale")
        mlp = sd[f"{bp}.linear1.weight"].shape[0] - 3 * h
        split(f"{bp}.linear1", ["attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp"], dp,
              [h, h, h, mlp])
    sd.check_all_read()
    return convert_diffusers_flux(d, config)
