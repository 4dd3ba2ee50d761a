"""JAX-package parameter trees -> the port's state_dict.

Takes a Flux, Wan, SD3, Chroma, Qwen-Image, FLUX.2, AuraFlow, Lumina 2, HiDream,
Cosmos, HunyuanVideo, HunyuanImage-2.1, HunyuanVideo-1.5, LTX-Video or LTX-2
parameter tree as the JAX
package builds it (a nested dict of numpy arrays, optionally under a top-level "params"
key, with any flax partition boxes already removed) and returns the
state_dict of the port's transformer of that family, so both packages
compute the same function:

- a Dense `kernel` [in, out] becomes `weight` [out, in]; the Conv3d
  `kernel` [kt, kh, kw, in, out] (Wan's patch embedding) becomes `weight`
  [out, in, kt, kh, kw];
- `bias`, `lora_a` [in, rank], `lora_b` [rank, out], the LoKr factors
  `lokr_w1` [in_m, out_m], `lokr_w2` [in_n, out_n], `lokr_w2_a` [in_n,
  rank] and `lokr_w2_b` [rank, out_n], RMSNorm `scale`, `kernel_scale`
  [out] and the other parameters keep their names and layout (lora_a and
  the LoKr w2 factors stay stored unshifted);
- float8 and int8 leaves cross by their bits: an int8 `kernel` [in, out]
  (pre-quantized) becomes an int8 `weight` [out, in], an ml_dtypes
  float8_e4m3fn array a torch.float8_e4m3fn tensor;
- the scanned block stacks carry a leading [L] axis, split into the
  ModuleList entries `double_blocks.{i}.*` and `single_blocks.{i}.*` (Flux,
  Chroma, FLUX.2), `joint_blocks.{i}.*` and `single_blocks.{i}.*`
  (AuraFlow) or `blocks.{i}.*` (Wan, SD3, Qwen-Image); the other subtrees
  (SD3's `final_block`, Chroma's `distilled_guidance_layer`) become dotted names.

flux2_config / auraflow_config give the port's config of a JAX model's
config: for FLUX.2 the JAX module's layout (GELU MLP at ratio 4, biased
top linears, txt_norm, 3 RoPE axes at theta 10,000), which the port
otherwise takes only from a checkpoint's keys. auraflow_state_dict reorders
the JAX patch projection into the port's (diffusers') patch order.
lumina2_config / lumina2_state_dict do it for the JAX Lumina2Transformer of
all three of its families (Lumina 2, Z-Image, OmniGen2): the scanned
`layers/Lumina2Block_0/...` stack becomes `layers.{i}.*` and the unrolled
`context_refiner_{i}` / `noise_refiner_{i}` become `context_refiner.{i}` /
`noise_refiner.{i}`.
hidream_config / hidream_state_dict do it for the JAX HiDreamTransformer:
its form of the text carry (T5 alone), of the Llama layers (cycled) and of
RoPE ((32, 48, 48)), and its stacked `experts_w1 / w2 / w3` [E, in, out]
and `caption_projection` [blocks, llama_dim, dim] split into the port's
per-expert and per-block linears.

cosmos_predict2_config / cosmos_predict2_state_dict do it for the JAX
CosmosPredict2Transformer (Cosmos-Predict2, Anima, Cosmos-1): the scanned
`blocks` stack becomes `blocks.{i}.*` under the JAX module's own names, and
Anima's `llm_adapter` subtree goes through llm_adapter_state_dict into the
port's (the reference's) names: `blocks_{i}_cross_attn` as
`blocks.{i}.cross_attn`, `blocks_{i}_mlp1` as `blocks.{i}.mlp.0`.

hunyuan_video_config / hunyuan_video_state_dict and hunyuan_image_config /
hunyuan_image_state_dict do it for the JAX HunyuanVideoTransformer and
HunyuanImageTransformer: the embedders' `time_in_1` / `_2` as
`time_in.linear_1` / `_2`, the refiner's `refiner_{i}` as `refiner.{i}`, and
the head's rows reordered from the JAX module's (pt, ph, pw, c) patch order
to the port's (hyvideo's) (c, pt, ph, pw); HunyuanImage's 2-D `img_in`
kernel becomes torch's [out, in, ph, pw]. hunyuan_vae_config /
hunyuan_vae_state_dict do it for the JAX HunyuanVAE: its form (spatial zero
padding, attention within each frame, its time-upsampling blocks, no quant
convolutions) and its `down_{i}_res_{j}` / `mid_attn` names as diffusers'
`down_blocks.{i}.resnets.{j}` / `mid_block.attentions.0`.
hunyuan_video_15_config / hunyuan_video_15_state_dict do it for the JAX
HunyuanVideo15Transformer (its `cond_type_embedding` `embedding` as
`weight`); ltx_video_config (the JAX block form, jax_form) / ltx2_config
with ltx_video_state_dict / ltx2_state_dict for the JAX LTXTransformer and
LTX2Transformer (`adaln_linear_{i}` / `adaln_proj` as `adaln_single.
linear_{i}` / `.proj`, the connector's `attn_q_{i}` as `blocks.{i}.
attn_q`); ltx_vae_config / ltx_vae_state_dict for the JAX LTXVideoVAE (its
form, and its `down_{g}_*` names as Lightricks' flat `down_blocks.{k}`).

tree_to_state_dict does the same for the Flux VAE, UMT5, the Wan 2.1 and
2.2 VAEs, the CLIP vision tower and SDXL's UNet and CLIP text towers
(models/autoencoder_kl.py, umt5.py, wan_vae.py, wan_vae22.py, wan_clip.py,
sdxl_unet.py, clip_text.py; for the towers it is the counterpart of the
JAX sdxl_convert.flax_hf_to_torch_sd): a Conv `kernel` [..., in, out] of
any rank becomes torch's `weight` [out, in, ...], a Dense `kernel` is
transposed, an Embed `embedding` and a norm `scale` become `weight`, and
the unrolled `block_{i}` / `layer_{i}` modules become the ModuleList
entries `blocks.{i}` / `layers.{i}` (also the LLM text towers and the
Qwen2.5-VL vision tower, models/llm_encoders.py, vision_encoders.py; the
Cosmos tokenizer, models/cosmos_tokenizer.py).

Only numpy and torch are used here.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

STACKED = ("double_blocks", "single_blocks", "blocks", "joint_blocks")


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


# a Dense kernel [in, out] -> weight [out, in]; the Conv3d kernel [kt, kh,
# kw, in, out] -> weight [out, in, kt, kh, kw]
_KERNEL_TO_WEIGHT = {2: (1, 0), 5: (4, 3, 0, 1, 2)}


def _leaf(path, arr) -> tuple:
    name = path[-1]
    if name == "kernel" and arr.ndim == 5:  # Conv3d
        return "weight", np.transpose(arr, _KERNEL_TO_WEIGHT[5])
    if name == "kernel":
        return "weight", np.swapaxes(arr, -1, -2)
    return name, arr


def jax_layout(name: str, ndim: int) -> Optional[tuple]:
    """The permutation that lays the port's parameter `name` (a Flux, Wan,
    SD3 or Chroma state_dict key, of rank ndim) out as the JAX package's
    leaf: the inverse of the one jax_to_state_dict gives a `kernel`, which
    is what every `weight` of these models comes from. None for the leaves that keep
    their layout."""
    if name.rsplit(".", 1)[-1] != "weight" or ndim not in _KERNEL_TO_WEIGHT:
        return None
    perm = _KERNEL_TO_WEIGHT[ndim]
    return tuple(perm.index(i) for i in range(ndim))


# ml_dtypes' float8 arrays: torch.from_numpy takes none, so they cross as bytes
_FLOAT8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no numpy twin in torch
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    if arr.dtype.name in _FLOAT8:
        bits = np.ascontiguousarray(arr).view(np.uint8)
        return torch.from_numpy(bits.copy()).view(_FLOAT8[arr.dtype.name])
    return torch.tensor(arr)  # a copy: arrays from JAX are read-only


def jax_to_state_dict(params: Mapping[str, Any],
                      dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """State_dict entries for every leaf of `params` (see module docstring).

    A subtree (e.g. only the trainable LoRA leaves) gives the matching subset
    of entries. dtype casts every tensor wider than a byte (not the fp8 or
    int8 weights) when set.
    """
    if "params" in params and len(params) == 1:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        if arr is None:
            continue
        name, val = _leaf(path, np.asarray(arr))
        if path[0] in STACKED:
            for i in range(val.shape[0]):
                key = ".".join((path[0], str(i)) + path[1:-1] + (name,))
                out[key] = _to_tensor(val[i])
        else:
            key = ".".join(path[:-1] + (name,))
            out[key] = _to_tensor(val)
    if dtype is not None:
        out = {k: v.to(dtype) if v.element_size() > 1 else v for k, v in out.items()}
    return out


def load_state_dict(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor],
                    partial: bool = False) -> None:
    """model.load_state_dict(state_dict), where an integer entry (an int8
    weight of a pre-quantized state) first replaces its float parameter by a
    frozen integer one of the entry's dtype, since a copy into the float
    parameter would convert the values. partial: entries the dict lacks
    keep their values (a converted checkpoint holds no adapter factors);
    an entry the model lacks still raises."""
    params = dict(model.named_parameters())
    for key, val in state_dict.items():
        p = params.get(key)
        if p is not None and not val.is_floating_point() and p.is_floating_point():
            owner, name = key.rsplit(".", 1) if "." in key else ("", key)
            setattr(model.get_submodule(owner), name, torch.nn.Parameter(
                torch.empty(val.shape, dtype=val.dtype, device=p.device), requires_grad=False))
    unexpected = model.load_state_dict(state_dict, strict=not partial).unexpected_keys
    if unexpected:
        raise KeyError(f"entries the model does not have: {unexpected[:5]}")


_CONV_TO_TORCH = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 2: (1, 0)}
_BLOCK = re.compile(r"^(block|layer)_(\d+)$")


def tree_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port module's state_dict from a JAX VAE, UMT5, CLIP-vision,
    SDXL UNet or CLIP text parameter tree (see module docstring)."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        arr = np.asarray(arr)
        name = path[-1]
        if name == "kernel":
            name, arr = "weight", np.transpose(arr, _CONV_TO_TORCH[arr.ndim])
        elif name in ("embedding", "scale"):
            name = "weight"
        parts = [_BLOCK.sub(r"\1s.\2", p) for p in path[:-1]]
        out[".".join(parts + [name])] = _to_tensor(np.ascontiguousarray(arr))
    return out


def _torch_dtype(jax_dtype) -> torch.dtype:
    """A JAX / numpy dtype (e.g. jnp.float32) as the torch dtype of its name."""
    from .common import dtype_from_string

    return dtype_from_string(np.dtype(jax_dtype).name)


def _shared_fields(jax_config, port_cls, **over) -> dict:
    """The fields of port_cls that jax_config also has, dtypes translated."""
    import dataclasses

    kw = {}
    for f in dataclasses.fields(port_cls):
        if not hasattr(jax_config, f.name) or f.name == "remat":
            continue
        val = getattr(jax_config, f.name)
        if f.name in ("dtype", "param_dtype", "lora_dtype") or (
                f.name == "base_kernel_dtype" and val is not None):
            val = _torch_dtype(val)
        kw[f.name] = tuple(val) if isinstance(val, list) else val
    kw.update(over)
    return kw


def flux2_config(jax_config, **over):
    """The port's Flux2Config computing what the JAX Flux2Transformer of
    `jax_config` computes: its sizes and adapter, in the JAX module's layout
    (flux2.JAX_LAYOUT: GELU MLP, biases, txt_norm, its RoPE axes and ids)."""
    from .models.flux2 import JAX_LAYOUT, Flux2Config

    kw = _shared_fields(jax_config, Flux2Config, **over)
    for key in ("mlp_gated", "use_bias", "txt_norm"):
        kw.setdefault(key, JAX_LAYOUT[key])
    return Flux2Config(**kw)


def auraflow_config(jax_config, **over):
    """The port's AuraFlowConfig of a JAX AuraFlowConfig (the same fields)."""
    from .models.auraflow import AuraFlowConfig

    return AuraFlowConfig(**_shared_fields(jax_config, AuraFlowConfig, **over))


def auraflow_state_dict(params: Mapping[str, Any], config,
                        dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """jax_to_state_dict of a JAX AuraFlow tree, with the patch projection's
    columns reordered from the JAX (row, col, channel) patch order to the
    port's (channel, row, col) (models/auraflow.py)."""
    from .models.auraflow import patch_proj_from_jax

    sd = jax_to_state_dict(params, dtype)
    if "patch_proj.weight" in sd:
        sd["patch_proj.weight"] = patch_proj_from_jax(sd["patch_proj.weight"],
                                                      config.in_channels, config.patch_size)
    return sd


def lumina2_config(jax_config, **over):
    """The port's Lumina2Config computing what the JAX Lumina2Transformer of
    `jax_config` computes: its sizes, RoPE and adapter, t scaled by 1,000
    as the JAX module scales it for every family (the port's Lumina 2 takes
    time_scale 1)."""
    from .models.lumina_2 import Lumina2Config

    kw = _shared_fields(jax_config, Lumina2Config)
    kw.setdefault("time_scale", 1000.0)
    kw.update(over)
    return Lumina2Config(**kw)


_LUMINA_REFINER = re.compile(r"^(context_refiner|noise_refiner)_(\d+)\.")


def lumina2_state_dict(params: Mapping[str, Any],
                       dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """jax_to_state_dict of a JAX Lumina2Transformer tree (any of the three
    families, or a subtree such as its LoRA factors) as the port's module
    names: the scanned main stack `layers/Lumina2Block_0/<leaf>` [L, ...]
    split into `layers.{i}.<leaf>`, the refiners `context_refiner_{i}.*` as
    `context_refiner.{i}.*`."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    rest = {k: v for k, v in params.items() if k != "layers"}
    out = {_LUMINA_REFINER.sub(r"\1.\2.", k): v for k, v in jax_to_state_dict(rest, dtype).items()}
    if "layers" in params:
        stack = params["layers"]
        stack = stack.get("Lumina2Block_0", stack)
        for key, val in jax_to_state_dict({"blocks": stack}, dtype).items():
            out["layers." + key[len("blocks."):]] = val
    return out


def hidream_config(jax_config, **over):
    """The port's HiDreamConfig computing what the JAX HiDreamTransformer of
    `jax_config` computes: its sizes, adapter and RoPE axes, the text carry
    of T5 alone, and its Llama layers (cycled i % L where it sets none)."""
    from .models.hidream import HiDreamConfig

    kw = _shared_fields(jax_config, HiDreamConfig)
    kw["llama_layers"] = (tuple(jax_config.llama_layers) if jax_config.llama_layers
                          else "cycle")
    kw["published_carry"] = False
    kw.update(over)
    return HiDreamConfig(**kw)


# the JAX HiDream leaves whose port module has another name
_HIDREAM_NAMES = (("ff_i.shared_w", "ff_i.shared.w"), ("txt_ff_w", "ff_t.w"))


def hidream_state_dict(params: Mapping[str, Any],
                       dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """jax_to_state_dict of a JAX HiDreamTransformer tree (or a subtree such
    as its LoRA factors) as the port's module names: `ff_i/shared_w{n}` as
    `ff_i.shared.w{n}`, `txt_ff_w{n}` as `ff_t.w{n}`, each block's expert
    bank `ff_i/experts_w{n}` [E, in, out] as E linears
    `ff_i.experts.{j}.w{n}.weight` [out, in], and `caption_projection`
    [blocks, in, out] as `caption_projection.{i}.weight`."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in jax_to_state_dict(params, dtype).items():
        for old, new in _HIDREAM_NAMES:
            key = key.replace(old, new)
        head, _, leaf = key.rpartition(".")
        if leaf.startswith("experts_w"):
            for j in range(val.shape[0]):
                out[f"{head}.experts.{j}.{leaf[len('experts_'):]}.weight"] = \
                    val[j].t().contiguous()
        elif key == "caption_projection":
            for i in range(val.shape[0]):
                out[f"caption_projection.{i}.weight"] = val[i].t().contiguous()
        else:
            out[key] = val
    return out


def cosmos_predict2_config(jax_config, **over):
    """The port's CosmosPredict2Config of a JAX CosmosPredict2Config (the
    same fields, its RoPE ratios and adapter included)."""
    from .models.cosmos_predict2_model import CosmosPredict2Config

    return CosmosPredict2Config(**_shared_fields(jax_config, CosmosPredict2Config, **over))


# the JAX LLMAdapter's unrolled block leaves -> the port's (the reference's) names
_ADAPTER_NAMES = ((r"^blocks_(\d+)_norm_self\.", r"blocks.\1.norm_self_attn."),
                  (r"^blocks_(\d+)_norm_cross\.", r"blocks.\1.norm_cross_attn."),
                  (r"^blocks_(\d+)_norm_mlp\.", r"blocks.\1.norm_mlp."),
                  (r"^blocks_(\d+)_mlp1\.", r"blocks.\1.mlp.0."),
                  (r"^blocks_(\d+)_mlp2\.", r"blocks.\1.mlp.2."),
                  (r"^blocks_(\d+)_(self_attn|cross_attn)\.", r"blocks.\1.\2."),
                  (r"^embed\.embedding$", "embed.weight"))


def llm_adapter_state_dict(params: Mapping[str, Any],
                           dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """jax_to_state_dict of a JAX LLMAdapter tree as the port module's names:
    `blocks_{i}_cross_attn/q_proj` as `blocks.{i}.cross_attn.q_proj`,
    `blocks_{i}_norm_mlp` as `blocks.{i}.norm_mlp`, `blocks_{i}_mlp1 /
    mlp2` as `blocks.{i}.mlp.0 / .2`, the Embed's `embedding` as
    `embed.weight`."""
    out = {}
    for key, val in jax_to_state_dict(params, dtype).items():
        for pat, rep in _ADAPTER_NAMES:
            key = re.sub(pat, rep, key)
        out[key] = val
    return out


def cosmos_predict2_state_dict(params: Mapping[str, Any],
                               dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """jax_to_state_dict of a JAX Cosmos-Predict2 / Anima / Cosmos-1 tree (or
    a subtree such as its LoRA factors): the scanned `blocks` stack split
    into `blocks.{i}.*` (the port keeps the JAX module's names), Anima's
    `llm_adapter` subtree through llm_adapter_state_dict under
    `llm_adapter.`."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    out = jax_to_state_dict({k: v for k, v in params.items() if k != "llm_adapter"}, dtype)
    if params.get("llm_adapter") is not None:
        out.update({f"llm_adapter.{k}": v
                    for k, v in llm_adapter_state_dict(params["llm_adapter"], dtype).items()})
    return out


def hunyuan_video_config(jax_config, **over):
    """The port's HunyuanVideoConfig of a JAX HunyuanVideoConfig (the same
    fields, its adapter included)."""
    from .models.hunyuan_video_model import HunyuanVideoConfig

    return HunyuanVideoConfig(**_shared_fields(jax_config, HunyuanVideoConfig, **over))


def hunyuan_image_config(jax_config, **over):
    """The port's HunyuanImageConfig of a JAX HunyuanImageConfig, with the
    JAX module's byt5_in GELU (tanh)."""
    from .models.hunyuan_image import HunyuanImageConfig

    kw = _shared_fields(jax_config, HunyuanImageConfig)
    kw.setdefault("byt5_gelu", "tanh")
    kw.update(over)
    return HunyuanImageConfig(**kw)


_HUNYUAN_NAMES = ((r"^(time_in|vector_in|guidance_in|refiner_t_embed|refiner_c_embed)_(\d)\.",
                   r"\1.linear_\2."),
                  (r"^refiner_(\d+)\.", r"refiner.\1."),
                  (r"^byt5_layernorm\.(scale|bias)$", r"byt5_in.layernorm_\1"),
                  (r"^byt5_fc(\d)\.", r"byt5_in.fc\1."),
                  (r"^cond_type_embedding\.embedding$", "cond_type_embedding.weight"))


def _patch_rows_from_jax(t: torch.Tensor, channels: int) -> torch.Tensor:
    """Rows (or a bias) ordered (patch..., c) -> (c, patch...)."""
    p = t.shape[0] // channels
    return t.reshape(p, channels, *t.shape[1:]).transpose(0, 1).reshape(t.shape).contiguous()


def hunyuan_video_state_dict(params: Mapping[str, Any], config,
                             dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """jax_to_state_dict of a JAX HunyuanVideoTransformer or
    HunyuanImageTransformer tree (or a subtree such as its LoRA factors) as
    the port's module names, final_linear's rows in the port's patch order
    (see module docstring); config: the port's config of the model."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in jax_to_state_dict(params, dtype).items():
        for pat, rep in _HUNYUAN_NAMES:
            key = re.sub(pat, rep, key)
        if key.startswith("final_linear.") and key.endswith(("weight", "bias")):
            val = _patch_rows_from_jax(val, config.out_channels)
        if key == "img_in.weight" and val.dim() == 4:  # a Conv2d kernel, as [ph, pw, out, in]
            val = val.permute(2, 3, 0, 1).contiguous()
        out[key] = val
    return out


hunyuan_image_state_dict = hunyuan_video_state_dict
hunyuan_video_15_state_dict = hunyuan_video_state_dict


def hunyuan_video_15_config(jax_config, **over):
    """The port's HunyuanVideo15Config of a JAX HunyuanVideo15Config: its
    sizes (in_channels 2 x latent + 1), patch and adapter, the byt5_in GELU
    in its tanh form."""
    from .models.hunyuan_video_15 import HunyuanVideo15Config

    return HunyuanVideo15Config(**_shared_fields(jax_config, HunyuanVideo15Config, **over))


def hunyuan_vae_config(jax_config, **over):
    """The port's HunyuanVAEConfig computing what the JAX HunyuanVAE of
    `jax_config` computes: its sizes, its form (jax_form) and no quant
    convolutions (models/hunyuan_vae.py)."""
    import dataclasses

    from .models.hunyuan_vae import HunyuanVAEConfig

    kw = {f.name: getattr(jax_config, f.name) for f in dataclasses.fields(HunyuanVAEConfig)
          if hasattr(jax_config, f.name)}
    kw["dtype"] = _torch_dtype(kw["dtype"])
    kw["block_out_channels"] = tuple(kw["block_out_channels"])
    kw.update(jax_form=True, quant_convs=False)
    kw.update(over)
    return HunyuanVAEConfig(**kw)


_HUNYUAN_VAE_NAMES = ((r"\.(down|up)_(\d+)_res_(\d+)\.", r".\1_blocks.\2.resnets.\3."),
                      (r"\.down_(\d+)_downsample\.", r".down_blocks.\1.downsamplers.0.conv."),
                      (r"\.up_(\d+)_upsample\.", r".up_blocks.\1.upsamplers.0.conv."),
                      (r"\.mid_res_(\d)\.", r".mid_block.resnets.\1."),
                      (r"\.mid_attn\.", ".mid_block.attentions.0."),
                      (r"\.to_out\.", ".to_out.0."),
                      (r"\.conv_shortcut\.(weight|bias)$", r".conv_shortcut.conv.\1"))


def hunyuan_vae_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """tree_to_state_dict of a JAX HunyuanVAE tree as the port's (diffusers')
    names."""
    out = {}
    for key, val in tree_to_state_dict(params).items():
        for pat, rep in _HUNYUAN_VAE_NAMES:
            key = re.sub(pat, rep, key)
        out[key] = val
    return out


def ltx_video_config(jax_config, **over):
    """The port's LTXConfig computing what the JAX LTXTransformer of
    `jax_config` computes: its sizes and adapter, in the JAX module's form
    (jax_form: LayerNorm pre-norms, a normalised cross-attention input)."""
    from .models.ltx_video import LTXConfig

    return LTXConfig(**_shared_fields(jax_config, LTXConfig, **{"jax_form": True, **over}))


def ltx2_config(jax_config, **over):
    """The port's LTX2Config of a JAX LTX2Config (the same fields, its
    adapter included)."""
    from .models.ltx2 import LTX2Config

    return LTX2Config(**_shared_fields(jax_config, LTX2Config, **over))


_LTX_NAMES = ((r"^adaln_linear_(\d)\.", r"adaln_single.linear_\1."),
              (r"^adaln_proj\.", "adaln_single.proj."),
              (r"^video_embeddings_connector\.(attn_[qkvo]|mlp_in|mlp_out)_(\d+)\.",
               r"video_embeddings_connector.blocks.\2.\1."))


def ltx_video_state_dict(params: Mapping[str, Any],
                         dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """jax_to_state_dict of a JAX LTXTransformer or LTX2Transformer tree (or
    a subtree such as its LoRA factors) as the port's module names: the
    adaLN-single's `adaln_linear_{i}` / `adaln_proj` as `adaln_single.
    linear_{i}` / `.proj`, the connector's `attn_q_{i}` as `blocks.{i}.
    attn_q`."""
    out = {}
    for key, val in jax_to_state_dict(params, dtype).items():
        for pat, rep in _LTX_NAMES:
            key = re.sub(pat, rep, key)
        out[key] = val
    return out


ltx2_state_dict = ltx_video_state_dict


def ltx_vae_config(jax_config, **over):
    """The port's LTXVAEConfig computing what the JAX LTXVideoVAE of
    `jax_config` computes: its sizes in the JAX module's form (jax_form:
    (ph, pw, c) patch order, 2 x latent moments, no norm3)."""
    import dataclasses

    from .models.ltx_vae import LTXVAEConfig

    kw = {f.name: getattr(jax_config, f.name) for f in dataclasses.fields(LTXVAEConfig)
          if hasattr(jax_config, f.name)}
    kw["dtype"] = _torch_dtype(kw["dtype"])
    for k in ("block_out_channels", "layers_per_block", "spatio_temporal_scaling"):
        kw[k] = tuple(kw[k])
    kw.update(jax_form=True, **over)
    return LTXVAEConfig(**kw)


def ltx_vae_state_dict(params: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """tree_to_state_dict of a JAX LTXVideoVAE tree as the port's
    (Lightricks') names for `config` (the port's config of the VAE): the
    encoder's `down_{g}_res_{j}`, `down_{g}_downsample`, `down_{g}_conv_out`
    and `mid_res_{j}` as its flat `down_blocks.{k}` list; the decoder's
    `mid_res_{j}` / `up_{i}_*` as `mid.{j}` / `up_blocks.{i}.*`."""
    where, group = {}, -1
    for k, (kind, *_rest) in enumerate(config.encoder_blocks()):
        group += kind == "group"
        where[(kind, group)] = k
    mid = len(config.encoder_blocks()) - 1

    out = {}
    for key, val in tree_to_state_dict(params).items():
        key = re.sub(r"^encoder\.mid_res_(\d+)\.",
                     lambda m: f"encoder.down_blocks.{mid}.res_blocks.{m.group(1)}.", key)
        key = re.sub(r"^encoder\.down_(\d+)_res_(\d+)\.",
                     lambda m: (f"encoder.down_blocks.{where[('group', int(m.group(1)))]}"
                                f".res_blocks.{m.group(2)}."), key)
        key = re.sub(r"^encoder\.down_(\d+)_downsample\.",
                     lambda m: f"encoder.down_blocks.{where[('compress', int(m.group(1)))]}.",
                     key)
        key = re.sub(r"^encoder\.down_(\d+)_conv_out\.",
                     lambda m: f"encoder.down_blocks.{where[('change', int(m.group(1)))]}.", key)
        key = re.sub(r"^decoder\.mid_res_(\d+)\.", r"decoder.mid.\1.", key)
        key = re.sub(r"^decoder\.up_(\d+)_res_(\d+)\.", r"decoder.up_blocks.\1.res_blocks.\2.",
                     key)
        key = re.sub(r"^decoder\.up_(\d+)_(upsample|conv_out)\.", r"decoder.up_blocks.\1.\2.",
                     key)
        out[key] = val
    return out
