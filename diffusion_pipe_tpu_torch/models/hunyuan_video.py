"""HunyuanVideo (13 B): the pipeline.

Counterpart of diffusion_pipe_tpu/models/hunyuan_video.py. Rectified flow
over [B, 16, F, H, W] video latents (x_t = (1 - t) latents + t noise, the
target noise - latents) with t scaled by 1,000 and the distilled guidance
model.guidance x 1,000 (1.0 by default). The text is cached: LLaVA-Llama-3-8B's
hidden_states[-(hidden_state_skip_layer + 1)] under hyvideo's prompt
template, its first crop_start rows dropped (95 for video, 36 for images),
text_len rows (256) with their mask, and CLIP-L's pooled output. Latents
come from the causal 3D VAE (models/hunyuan_vae.py), 4x in time and 8x in
space.

The transformer's layout comes from the checkpoint's keys (the block and
refiner counts, whether guidance_in exists, the widths); a [model] size
knob (num_layers, num_single_layers) that disagrees raises, as does a key
the model lacks or does not take. Checkpoint keys are hyvideo's; the LoRA
goes out in the `transformer.` dialect.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..common import dtype_from_string
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .flux import resize_mask_to_latents
from .hunyuan_video_model import HunyuanVideoConfig, HunyuanVideoTransformer
from .layers import (adapter_kwargs, block_kernel_kwargs, init_module_weights, remat_spec)

# [model] knobs that set the transformer's depth
SIZE_KNOBS = ("num_layers", "num_single_layers")
TINY_TEXT_ROWS = 16

# hyvideo's PROMPT_TEMPLATE (dit-llm-encode-video / dit-llm-encode) and the
# template rows each drops
VIDEO_TEMPLATE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by detailing the "
    "following aspects: 1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial relationships of the "
    "objects.3. Actions, events, behaviors temporal relationships, physical movement changes "
    "of the objects.4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
IMAGE_TEMPLATE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the image by detailing the color, "
    "shape, size, texture, quantity, text, spatial relationships of the objects and "
    "background:<|eot_id|><|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
VIDEO_CROP_START, IMAGE_CROP_START = 95, 36


def mm_block_linears():
    """hyvideo's double- and single-block linears and norms (HunyuanImage-2.1
    has the same), the port's names on the left."""
    double = {f"{s}_{n}": f"{s}_{t}" for s in ("img", "txt")
              for n, t in (("mod", "mod.linear"), ("attn_qkv", "attn_qkv"),
                           ("attn_proj", "attn_proj"), ("mlp_fc1", "mlp.fc1"),
                           ("mlp_fc2", "mlp.fc2"))}
    double_norms = {f"{s}_attn_{p}_norm": f"{s}_attn_{p}_norm" for s in ("img", "txt")
                    for p in ("q", "k")}
    single = {"modulation": "modulation.linear", "linear1": "linear1", "linear2": "linear2"}
    return double, double_norms, single, {"q_norm": "q_norm", "k_norm": "k_norm"}


def mm_keymap(cfg, top_linears: Dict[str, str], lora_prefix: str, **top):
    """The KeyMap of a hyvideo-style DiT: the refiner's blocks, the double
    and single blocks, txt_in, the head and img_in's patch convolution,
    with the family's other top-level linears."""
    from .keymaps import BlockGroup, KeyMap

    top_linears = dict(top_linears)
    top_linears.update({
        "txt_in_proj": "txt_in.input_embedder",
        "refiner_t_embed.linear_1": "txt_in.t_embedder.mlp.0",
        "refiner_t_embed.linear_2": "txt_in.t_embedder.mlp.2",
        "refiner_c_embed.linear_1": "txt_in.c_embedder.linear_1",
        "refiner_c_embed.linear_2": "txt_in.c_embedder.linear_2",
        "final_linear": "final_layer.linear",
        "final_mod": "final_layer.adaLN_modulation.1",
    })
    top_raw = dict(top.pop("top_raw", {}))
    for i in range(cfg.refiner_layers):
        ref = f"txt_in.individual_token_refiner.blocks.{i}"
        top_linears.update({
            f"refiner.{i}.adaLN_linear": f"{ref}.adaLN_modulation.1",
            f"refiner.{i}.self_attn_qkv": f"{ref}.self_attn_qkv",
            f"refiner.{i}.self_attn_proj": f"{ref}.self_attn_proj",
            f"refiner.{i}.mlp_in": f"{ref}.mlp.fc1",
            f"refiner.{i}.mlp_out": f"{ref}.mlp.fc2",
        })
        for n in (1, 2):
            top_raw[f"refiner.{i}.norm{n}_scale"] = f"{ref}.norm{n}.weight"
            top_raw[f"refiner.{i}.norm{n}_bias"] = f"{ref}.norm{n}.bias"
    double, double_norms, single, single_norms = mm_block_linears()
    return KeyMap(
        blocks=[BlockGroup("double_blocks", "double_blocks", "num_layers", linears=double,
                           norms=double_norms),
                BlockGroup("single_blocks", "single_blocks", "num_single_layers",
                           linears=single, norms=single_norms)],
        top_linears=top_linears, top_raw=top_raw, top_convs={"img_in": "img_in.proj"},
        lora_prefix=lora_prefix, **top)


def hunyuan_video_keymap(cfg: HunyuanVideoConfig):
    """hyvideo HYVideoDiffusionTransformer keys <-> the port's names; LoRA
    with the `transformer.` prefix (the JAX _hv_keymap's export)."""
    top = {"time_in.linear_1": "time_in.mlp.0", "time_in.linear_2": "time_in.mlp.2",
           "vector_in.linear_1": "vector_in.in_layer",
           "vector_in.linear_2": "vector_in.out_layer"}
    if cfg.guidance_embeds:
        top.update({"guidance_in.linear_1": "guidance_in.mlp.0",
                    "guidance_in.linear_2": "guidance_in.mlp.2"})
    return mm_keymap(cfg, top, "transformer.")


def _shape(sd, key):
    if key not in sd:
        raise KeyError(f"the checkpoint lacks {key}, which its layout is read from")
    return tuple(sd[key].shape)


def mm_checkpoint_layout(sd) -> Dict[str, Any]:
    """What a (prefix-stripped) hyvideo-style checkpoint holds: the double,
    single and refiner block counts, the width and heads (the head dim from
    the q norm), the MLP ratio, img_in's channels and patch, the output
    channels and the text width. A key the layout needs and sd lacks raises
    KeyError naming it."""
    from .keymaps import count_blocks

    dim, in_ch, *patch = _shape(sd, "img_in.proj.weight")
    n_double = count_blocks(sd, "double_blocks")
    head = (_shape(sd, "double_blocks.0.img_attn_q_norm.weight") if n_double
            else _shape(sd, "single_blocks.0.q_norm.weight"))[0]
    mlp = (_shape(sd, "double_blocks.0.img_mlp.fc1.weight") if n_double
           else (_shape(sd, "single_blocks.0.linear1.weight")[0] - 3 * dim,))[0]
    return dict(num_layers=n_double, num_single_layers=count_blocks(sd, "single_blocks"),
                refiner_layers=count_blocks(sd, "txt_in.individual_token_refiner.blocks"),
                num_attention_heads=dim // head, attention_head_dim=head,
                mlp_ratio=mlp / dim, in_channels=in_ch, patch_size=tuple(patch),
                out_channels=_shape(sd, "final_layer.linear.weight")[0] // math.prod(patch),
                text_dim=_shape(sd, "txt_in.input_embedder.weight")[1])


def rename_keys(sd, pairs):
    """sd with each (old, new) of pairs replaced in its keys, in order."""
    out = {}
    for k, v in sd.items():
        for old, new in pairs:
            k = k.replace(old, new)
        out[k] = v
    return out


def load_mm_checkpoint(pipeline, config_attr: str, layout_fn, renames=(), drop_prefixes=()):
    """The checkpoint [model] names as the port's state dict (its keys
    renamed by `renames` first, those under drop_prefixes left out: a single
    file's `vae.*`), the model rebuilt on the checkpoint's layout_fn(sd)
    when it differs from the config (a [model] size that disagrees raises);
    a key missing or left over raises."""
    from .keymaps import (keymap_to_state_dict, layout_override, load_sd_for_pipeline,
                          strip_known_prefixes)

    sd = rename_keys(strip_known_prefixes(load_sd_for_pipeline(pipeline), pipeline.keymap()),
                     renames)
    sd = {k: v for k, v in sd.items() if not k.startswith(tuple(drop_prefixes))}
    layout = layout_override(pipeline.model_config, layout_fn(sd))
    cfg = getattr(pipeline, config_attr)
    if any(getattr(cfg, k) != v for k, v in layout.items()):
        setattr(pipeline, config_attr, pipeline._build_config(layout))
        with torch.device("meta"):
            pipeline.model = type(pipeline.model)(getattr(pipeline, config_attr))
    return keymap_to_state_dict(sd, pipeline.keymap(), getattr(pipeline, config_attr))


def hunyuan_video_layout(sd) -> Dict[str, Any]:
    """mm_checkpoint_layout with CLIP's width and whether guidance_in exists."""
    layout = mm_checkpoint_layout(sd)
    layout["pooled_projection_dim"] = _shape(sd, "vector_in.in_layer.weight")[1]
    layout["guidance_embeds"] = any(k.startswith("guidance_in.") for k in sd)
    return layout


def build_mm_config(pipeline, cls, layout: Optional[Dict] = None, knobs=SIZE_KNOBS, **extra):
    """The published config of `cls` (or its `_tiny` sizes), [model]'s dtype,
    transformer_dtype, int8_matmul, checkpointing, adapter and size `knobs`
    over it, `extra`, and `layout` (read from a checkpoint) over those."""
    mc = pipeline.model_config
    dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
    kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype,
                                  remat=remat_spec(pipeline.config), **block_kernel_kwargs(mc))
    kwargs.update(adapter_kwargs(pipeline.config, mc.get("dtype", "bfloat16")))
    kwargs.update({k: int(mc[k]) for k in knobs if mc.get(k) is not None})
    kwargs.update(extra)
    kwargs.update(layout or {})
    return cls.tiny(**kwargs) if mc.get("_tiny", False) else cls(**kwargs)


class HunyuanVAEMixin:
    """get_call_vae_fn over a Hunyuan video pipeline's causal 3D VAE (its
    `_load_vae`)."""

    def get_call_vae_fn(self):
        """fn(pixels [B, 3, F, H, W] or [B, 3, H, W] in [-1, 1], numpy) ->
        {"latents": [B, z, 1 + (F - 1) / 4, H / s, W / s]} f32 CPU tensors
        (z and the spatial factor s are the VAE's: 16 and 8 for
        HunyuanVideo, 32 and 16 for HunyuanVideo-1.5)."""

        def fn(pixels):
            vae = self._load_vae()
            px = torch.from_numpy(np.asarray(pixels, np.float32))
            if px.dim() == 4:
                px = px[:, :, None]
            with torch.no_grad():
                return {"latents": vae.encode(px.to(self.device)).float().cpu()}

        return fn


@register_model("hunyuan-video", "hunyuan_video")
class HunyuanVideoPipeline(HunyuanVAEMixin, BasePipeline):
    name = "hunyuan-video"
    framerate = 24
    # the cached text embeddings (the JAX package's names, so caches cross)
    text_keys = ("text_states", "text_mask", "clip_pooled")

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.hv_config = self._build_config()
        with torch.device("meta"):
            self.model = HunyuanVideoTransformer(self.hv_config)

    def _build_config(self, layout: Optional[Dict] = None) -> HunyuanVideoConfig:
        return build_mm_config(self, HunyuanVideoConfig, layout)

    def init_params(self, generator: torch.Generator) -> None:
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    # --- training -----------------------------------------------------------

    def _guidance(self, b: int) -> torch.Tensor:
        g = float(self.model_config.get("guidance", 1.0)) * 1000.0
        return torch.full((b,), g, dtype=torch.float32, device=self.device)

    def _text(self, batch, b: int):
        dt = self.hv_config.dtype
        return dict(text_states=batch["text_states"].to(self.device, dt),
                    text_mask=batch["text_mask"].to(self.device).reshape(b, -1),
                    pooled=batch["clip_pooled"].to(self.device, dt))

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 16, F, H, W], the cached text_states [B, S,
        4,096], text_mask [B, S] and clip_pooled [B, 768], optional mask [B,
        Hm, Wm] (resized to [B, 1, 1, H, W]). noise and t are drawn from
        `generator` unless given."""
        latents = batch["latents"].to(self.device, torch.float32)
        if latents.dim() == 4:
            latents = latents[:, :, None]
        b, _, _, h, w = latents.shape
        mask = batch.get("mask")
        if mask is not None:
            mask = resize_mask_to_latents(mask.to(self.device), h, w, 1)[:, :, None]
        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator, quantile=timestep_quantile,
                                 image_seq_len=(h // 2) * (w // 2), device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1, 1)
        x_t = (1.0 - t_exp) * latents + t_exp * noise
        inputs = dict(x=x_t.to(self.hv_config.dtype), t=t * 1000.0, guidance=self._guidance(b),
                      **self._text(batch, b))
        return inputs, noise - latents, mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, num_frames: int = 1,
               noise: Optional[torch.Tensor] = None, **embeds):
        """Euler flow sampling through the training forward: latents [B, 16,
        1 + (num_frames - 1) // 4, height / 8, width / 8] f32, sigmas shifted
        by model.shift (7 by default)."""
        from ..training.sampling import euler_flow_sample

        b = embeds["text_states"].shape[0]
        text = self._text(embeds, b)
        f = max(1, (int(num_frames) - 1) // 4 + 1)

        def vel(x, t):
            return self.forward(dict(x=x.to(self.hv_config.dtype), t=t * 1000.0,
                                     guidance=self._guidance(b), **text))

        return euler_flow_sample(vel, (b, self.hv_config.in_channels, f, height // 8, width // 8),
                                 generator, num_steps=num_steps, guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift", 7.0), noise=noise,
                                 device=self.device)

    # --- caching encoders ----------------------------------------------------

    def _load_vae(self):
        """The causal 3D VAE on the pipeline's device in the model dtype,
        frozen: seeded at a small width under `_tiny` (16 latent channels),
        else model.vae_path's (diffusers or original key dialect, its
        topology from the shapes)."""
        if getattr(self, "_vae", None) is None:
            from .hunyuan_vae import HunyuanVAE, HunyuanVAEConfig, load_hunyuan_vae

            mc = self.model_config
            dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
            if mc.get("_tiny", False):
                vae = HunyuanVAE(HunyuanVAEConfig.tiny(latent_channels=16, dtype=dtype))
                vae = vae.to(self.device)
                vae.init_weights(torch.Generator(device=self.device).manual_seed(0))
            else:
                vae = load_hunyuan_vae(mc["vae_path"], dtype=dtype, device=self.device)
            self._vae = vae.eval().requires_grad_(False)
        return self._vae

    def get_call_text_encoder_fns(self):
        """[LLaVA fn, CLIP fn], each captions -> {name: CPU tensor}: the
        template-cropped states {text_states} [B, text_len, 4,096] f32 with
        {text_mask} int32, and {clip_pooled} [B, 768]. Under `_tiny`, the
        JAX hook's seeded draws (16 rows, the first len(caption) + 1
        valid)."""
        from .llm_encoders import LLMTextEncoder
        from .text_encoders import HFTextEncoder

        mc = self.model_config
        if mc.get("_tiny", False):
            return [self._tiny_llm_fn, self._tiny_clip_fn]
        video = bool(mc.get("support_video", True))
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        kw = dict(device=self.device, dtype=te_dtype)
        skip = int(mc.get("hidden_state_skip_layer", 2))
        llm = LLMTextEncoder(mc["llm_path"], max_length=int(mc.get("text_len", 256)),
                             template=VIDEO_TEMPLATE if video else IMAGE_TEMPLATE,
                             crop_start=VIDEO_CROP_START if video else IMAGE_CROP_START,
                             hidden_layer=-(skip + 1), **kw)
        clip = HFTextEncoder("clip_pooled", mc["clip_path"], max_length=77, **kw)

        def llm_fn(captions):
            h, m = llm.encode(captions)
            return {"text_states": h, "text_mask": m.to(torch.int32)}

        def clip_fn(captions):
            return {"clip_pooled": clip.encode(captions)}

        return [llm_fn, clip_fn]

    def _tiny_llm_fn(self, captions):
        from ..data.bucketing import seed_from_hash

        cfg = self.hv_config
        states = np.zeros((len(captions), TINY_TEXT_ROWS, cfg.text_dim), np.float32)
        mask = np.zeros((len(captions), TINY_TEXT_ROWS), np.int32)
        for i, c in enumerate(captions):
            n = min(len(c) + 1, TINY_TEXT_ROWS)
            states[i, :n] = np.random.default_rng(seed_from_hash(c)).standard_normal(
                (n, cfg.text_dim))
            mask[i, :n] = 1
        return {"text_states": torch.from_numpy(states), "text_mask": torch.from_numpy(mask)}

    def _tiny_clip_fn(self, captions):
        from ..data.bucketing import seed_from_hash

        dim = self.hv_config.pooled_projection_dim
        return {"clip_pooled": torch.from_numpy(np.stack([
            np.random.default_rng(seed_from_hash(c + "clip")).standard_normal((dim,))
            for c in captions]).astype(np.float32))}

    # --- weights -------------------------------------------------------------

    def _keymap_config(self):
        return self.hv_config

    def keymap(self):
        return hunyuan_video_keymap(self.hv_config)

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The transformer [model] names (ckpt_path / transformer_path, ComfyUI
        fp8 dequantized, model.merge_adapters fused in) as the port's state
        dict, the model rebuilt on the checkpoint's layout first."""
        return load_mm_checkpoint(self, "hv_config", hunyuan_video_layout)
