"""Qwen-Image and Qwen-Image-Edit: the transformer and its pipeline.

Counterpart of diffusion_pipe_tpu/models/qwen_image.py (diffusers'
QwenImageTransformer2DModel): 60 dual-stream MMDiT blocks, each Flux's
double block (joint [txt, img] attention on K1-K3 with the text padding as
the key mask, per-head RMS q/k norms, adaLN-zero modulation, GELU MLPs),
with timestep-only conditioning, RMS-normed Qwen2.5-VL text features (3,584
wide) as context and 2 x 2 packed latents. Edit mode appends the control
image's latents to the image sequence; the output is cut to the target's
rows.

Where the port departs from the JAX module, on purpose:
- SiLU is applied to the timestep embedding once, by each block and by the
  output norm (diffusers' img_mod / txt_mod and AdaLayerNormContinuous);
  the JAX module applies it before the blocks as well.
- The RoPE ids are diffusers' QwenEmbedRope(scale_rope=True) ones
  (qwen_rope_ids): the image grid centred on the row and column axes,
  image k on frame k (the target 0, the control 1), the text from
  max(h // 2, w // 2) on, on all three axes. The JAX module builds Flux's
  uncentred ids.
- The VAE is Qwen-Image's own, the Wan 2.1 VAE on one frame with its
  per-channel latent mean and std (the JAX pipeline encodes with the Flux
  VAE as a stand-in), read from model.vae_path or <diffusers_path>/vae.
- The text encoder is read from model.text_encoder_path, else
  <diffusers_path>/text_encoder, so examples/qwen_image.toml runs as it is.

The block linears (14 a block) take the adapter, base_kernel_dtype (fp8
storage) and int8_matmul; the embedders, norms and head keep param_dtype.
With `remat` set each block runs under remat_call (every policy).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import dtype_from_string
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .flux import pack_latents, resize_mask_to_latents, unpack_latents
from .flux_model import FluxConfig, FluxDoubleBlock
from .layers import (LoraDense, RMSNorm, TimestepEmbedder, adapter_kwargs, block_kernel_kwargs,
                     init_module_weights, layer_norm, modulate, remat_call, remat_spec,
                     rope_frequencies)

TINY_TEXT_LENGTH = 8
# the t2i chat template and the tokens it puts before the caption; the
# edit template, its leading tokens and the control image's side
T2I_TEMPLATE = (
    "<|im_start|>system\nDescribe the image by detailing the color, shape, size, texture, "
    "quantity, text, spatial relationships of the objects and background:<|im_end|>\n"
    "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n")
T2I_DROP = 34
EDIT_TEMPLATE = (
    "<|im_start|>system\nDescribe the key features of the input image (color, shape, size, "
    "texture, objects, background), then explain how the user's text instruction should alter "
    "or modify the image. Generate a new image that meets the user's requirements while "
    "maintaining consistency with the original input where appropriate.<|im_end|>\n"
    "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>{}<|im_end|>\n"
    "<|im_start|>assistant\n")
EDIT_DROP = 64


@dataclasses.dataclass(frozen=True)
class QwenImageConfig:
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 60
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 3584   # Qwen2.5-VL-7B's width
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    base_kernel_dtype: Optional[torch.dtype] = None
    int8_matmul: Any = False
    lora_rank: int = 0
    lora_alpha: float = 0.0
    lora_dropout: float = 0.0
    lora_dtype: torch.dtype = torch.float32
    lora_type: str = "lora"
    lokr_factor: int = -1
    lokr_rank_dropout: float = 0.0
    remat: str = ""

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    def to_flux_config(self) -> FluxConfig:
        """The block-level config of the Flux double block."""
        return FluxConfig(**{f.name: getattr(self, f.name) for f in dataclasses.fields(FluxConfig)
                             if hasattr(self, f.name)})

    @staticmethod
    def tiny(**kw) -> "QwenImageConfig":
        """The JAX QwenImageConfig.tiny sizes."""
        d = dict(num_layers=2, attention_head_dim=32, num_attention_heads=4,
                 joint_attention_dim=48, axes_dims_rope=(8, 12, 12),
                 dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return QwenImageConfig(**d)


def qwen_rope_ids(grids: Sequence[Tuple[int, int]], txt_len: int, device=None):
    """diffusers' QwenEmbedRope(scale_rope=True) position ids: (img_ids
    [sum h * w, 3], txt_ids [txt_len, 3]) f32 as (frame, row, col). Image k
    of `grids` ((h, w) in packed tokens) sits on frame k with rows -(h - h //
    2) .. h // 2 - 1 and columns likewise; the text takes positions m ..
    m + txt_len - 1 on all three axes, m = max(h // 2, w // 2) over the
    images."""
    parts, start = [], 0
    for k, (h, w) in enumerate(grids):
        row = torch.arange(h, device=device) - (h - h // 2)
        col = torch.arange(w, device=device) - (w - w // 2)
        parts.append(torch.stack([torch.full((h * w,), k, device=device),
                                  row.repeat_interleave(w), col.repeat(h)], dim=-1))
        start = max(start, h // 2, w // 2)
    txt = (start + torch.arange(txt_len, device=device))[:, None].expand(txt_len, 3)
    return torch.cat(parts).float(), txt.float()


class QwenImageTransformer(nn.Module):
    def __init__(self, cfg: QwenImageConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.img_in = LoraDense(cfg.in_channels, dim, **dd)
        self.txt_norm = RMSNorm(cfg.joint_attention_dim, param_dtype=cfg.param_dtype)
        self.txt_in = LoraDense(cfg.joint_attention_dim, dim, **dd)
        self.time_text_embed = TimestepEmbedder(dim, **dd)
        fcfg = cfg.to_flux_config()
        self.blocks = nn.ModuleList([FluxDoubleBlock(fcfg) for _ in range(cfg.num_layers)])
        self.norm_out_linear = LoraDense(dim, 2 * dim, **dd)
        self.proj_out = LoraDense(dim, cfg.out_channels, **dd)

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(self, hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids,
                txt_mask=None, img_seq_len: Optional[int] = None):
        """hidden_states [B, S_img (+ S_control), 64] packed latents;
        encoder_hidden_states [B, S_txt, 3584]; timestep [B] in [0, 1];
        img_ids [S_img (+ S_control), 3] and txt_ids [S_txt, 3]
        (qwen_rope_ids); txt_mask [B, S_txt]; img_seq_len cuts the output
        to the target's rows."""
        cfg = self.cfg
        img = self.img_in(hidden_states.to(cfg.dtype))
        txt = self.txt_in(self.txt_norm(encoder_hidden_states.to(cfg.dtype)))
        temb = self.time_text_embed(timestep.float() * 1000.0)
        rope_cos, rope_sin = rope_frequencies(torch.cat([txt_ids, img_ids], dim=0),
                                              cfg.axes_dims_rope, cfg.rope_theta)
        for block in self.blocks:
            img, txt = self._run(block, img, txt, temb, rope_cos, rope_sin, txt_mask)
        out = img if img_seq_len is None else img[:, :img_seq_len]
        scale, shift = self.norm_out_linear(F.silu(temb)).chunk(2, dim=-1)  # diffusers order
        return self.proj_out(modulate(layer_norm(out), shift, scale))


class _ImageVAE:
    """The Wan 2.1 VAE on one frame: encode [B, 3, H, W] -> normalised
    latents [B, 16, H/8, W/8], decode back."""

    def __init__(self, vae):
        self.vae = vae

    def encode(self, x):
        return self.vae.encode(x[:, :, None])[:, :, 0]

    def decode(self, z):
        return self.vae.decode(z[:, :, None])[:, :, 0]


def qwen_checkpoint_layout(sd) -> Dict[str, Any]:
    """The layout a (prefix-stripped) diffusers QwenImageTransformer2DModel
    checkpoint holds: its block count, the head dim (the q-norm width) and
    heads, the text width and the latent channels."""
    from .keymaps import count_blocks

    head_dim = sd["transformer_blocks.0.attn.norm_q.weight"].shape[0]
    return dict(num_layers=count_blocks(sd, "transformer_blocks"), attention_head_dim=head_dim,
                num_attention_heads=sd["img_in.weight"].shape[0] // head_dim,
                joint_attention_dim=sd["txt_in.weight"].shape[1],
                in_channels=sd["img_in.weight"].shape[1],
                out_channels=sd["proj_out.weight"].shape[0])


@register_model("qwen_image", "qwen-image", "qwen_image_edit")
class QwenImagePipeline(BasePipeline):
    name = "qwen_image"
    # the latent cache's encoder tag: the JAX package caches Flux-VAE
    # latents under the same folder
    latent_cache_tag = "wan21-vae"

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        mc = self.model_config
        self.edit = mc["type"] == "qwen_image_edit"
        self.tdist = TimestepDistribution.from_model_config(mc)
        self.qi_config = self._build_config()
        with torch.device("meta"):
            self.model = QwenImageTransformer(self.qi_config)

    def _build_config(self, layout: Optional[Dict] = None) -> QwenImageConfig:
        """The published layout (60 blocks, 24 heads of 128, text 3,584),
        the `_tiny` test layout, or `layout` (what load_weights read from a
        checkpoint); [model]'s num_layers overrides the block count."""
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype,
                                      remat=remat_spec(self.config), **block_kernel_kwargs(mc))
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        if mc.get("num_layers") is not None:
            kwargs["num_layers"] = int(mc["num_layers"])
        kwargs.update(layout or {})
        if mc.get("_tiny", False):
            return QwenImageConfig.tiny(**kwargs)
        return QwenImageConfig(**kwargs)

    def init_params(self, generator: torch.Generator) -> None:
        """Every weight on the pipeline's device, filled as the JAX package
        initialises it."""
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    def _inputs(self, x_packed, embeds, t, h, w, mask, n_images: int):
        b = x_packed.shape[0]
        dtype = self.qi_config.dtype
        img_ids, txt_ids = qwen_rope_ids([(h // 2, w // 2)] * n_images, embeds.shape[1],
                                         device=self.device)
        return dict(
            hidden_states=x_packed.to(dtype),
            encoder_hidden_states=embeds.to(self.device, dtype),
            timestep=t, img_ids=img_ids, txt_ids=txt_ids,
            txt_mask=None if mask is None else mask.reshape(b, -1).to(self.device),
            img_seq_len=(h // 2) * (w // 2),
        )

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 16, H, W] (or [B, 16, 1, H, W]), prompt_embeds
        [B, S, 3584], prompt_embeds_mask [B, S], optional mask [B, Hm, Wm]
        and control_latents (edit). t follows the image-sequence-dependent
        shift of the timestep distribution. noise and t are drawn from
        `generator` unless given."""
        latents = batch["latents"].to(self.device, torch.float32)
        if latents.dim() == 5:
            latents = latents[:, :, 0]
        b, c, h, w = latents.shape
        mask = batch.get("mask")
        if mask is not None:
            mask = pack_latents(resize_mask_to_latents(mask.to(self.device), h, w, c))
        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator, quantile=timestep_quantile,
                                 image_seq_len=(h // 2) * (w // 2), device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1)
        x_t = pack_latents((1.0 - t_exp) * latents + t_exp * noise)
        n_images = 1
        control = batch.get("control_latents")
        if control is not None:
            control = control.to(self.device, torch.float32)
            if control.dim() == 5:
                control = control[:, :, 0]
            x_t = torch.cat([x_t, pack_latents(control)], dim=1)
            n_images = 2
        inputs = self._inputs(x_t, batch["prompt_embeds"], t, h, w,
                              batch.get("prompt_embeds_mask"), n_images)
        return inputs, pack_latents(noise - latents), mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, prompt_embeds, width: int, height: int, generator=None,
               num_steps: int = 20, guidance_scale: float = 1.0, prompt_embeds_mask=None,
               control_latents=None, noise: Optional[torch.Tensor] = None, **_unused):
        """Euler flow sampling through the training forward: latents [B, 16,
        height/8, width/8] f32, model.shift as the sigmas' shift (none by
        default); control_latents [B, 16, h, w] condition an edit."""
        from ..training.sampling import euler_flow_sample

        b = prompt_embeds.shape[0]
        h, w = height // 8, width // 8
        ctrl = None if control_latents is None else pack_latents(
            control_latents.to(self.device, torch.float32))

        def vel(x, t):
            x = pack_latents(x)
            if ctrl is not None:
                x = torch.cat([x, ctrl], dim=1)
            out = self.forward(self._inputs(x, prompt_embeds, t, h, w, prompt_embeds_mask,
                                            1 if ctrl is None else 2))
            return unpack_latents(out.float(), h, w)

        return euler_flow_sample(vel, (b, 16, h, w), generator, num_steps=num_steps,
                                 guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift"), noise=noise,
                                 device=self.device)

    # --- caching encoders ----------------------------------------------------

    def _path(self, key: str, sub: str) -> str:
        mc = self.model_config
        if mc.get(key):
            return str(mc[key])
        if not mc.get("diffusers_path"):
            raise KeyError(f"model.{key} or model.diffusers_path is required")
        return str(Path(mc["diffusers_path"]) / sub)

    def _load_vae(self):
        """Qwen-Image's VAE (the Wan 2.1 VAE, 16 latent channels normalised
        by WAN21_LATENT_MEAN / STD) on one frame, on the pipeline's device in
        the model dtype, frozen: seeded at a small width under `_tiny`, else
        from model.vae_path or <diffusers_path>/vae in any layout
        wan_vae_convert reads (the reference .pth, diffusers'
        AutoencoderKLQwenImage / AutoencoderKLWan)."""
        if getattr(self, "_vae", None) is None:
            from .wan_vae import WanVAEConfig, WanVideoVAE
            from .wan_vae_convert import load_wan_vae

            mc = self.model_config
            dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
            if mc.get("_tiny", False):
                vae = WanVideoVAE(WanVAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 4),
                                               num_res_blocks=1,
                                               temperal_downsample=(True, True), dtype=dtype))
                vae = vae.to(self.device)
                vae.init_weights(torch.Generator(device=self.device).manual_seed(0))
                vae = vae.eval().requires_grad_(False)
            else:
                vae = load_wan_vae(self._path("vae_path", "vae"), dtype=dtype, device=self.device)
            self._vae = _ImageVAE(vae)
        return self._vae

    def get_call_vae_fn(self):
        """fn(pixels [B, 3, H, W] or [B, 3, 1, H, W] in [-1, 1], numpy) ->
        {"latents": [B, 16, H/8, W/8] f32 CPU tensor}."""

        def fn(pixels):
            vae = self._load_vae()
            x = torch.from_numpy(np.asarray(pixels, np.float32))
            if x.dim() == 5:
                x = x[:, :, 0]
            with torch.no_grad():
                return {"latents": vae.encode(x.to(self.device)).float().cpu()}

        return fn

    def get_call_text_encoder_fns(self):
        """[fn]: t2i fn(captions), edit fn(captions, control_files), each ->
        {"prompt_embeds": [B, S, 3584] f32, "prompt_embeds_mask": [B, S]
        int32} CPU tensors. Qwen2.5-VL from model.text_encoder_path (else
        <diffusers_path>/text_encoder), its tokenizer from that folder or
        <diffusers_path>/tokenizer, loaded at the first call; under `_tiny`
        the JAX hook's seeded draws (min(len(caption) + 1, 8) valid rows of
        8, zeros after)."""
        mc = self.model_config
        if mc.get("_tiny", False):
            return [self._tiny_text_fn()]
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        path = self._path("text_encoder_path", "text_encoder")
        tok = path
        if not (Path(path) / "tokenizer_config.json").exists() and mc.get("diffusers_path"):
            tok = str(Path(mc["diffusers_path"]) / "tokenizer")
        max_len = int(mc.get("max_sequence_length", 512))
        fp8 = bool(mc.get("text_encoder_fp8", False))
        if self.edit:
            return [QwenEditTextEncoder(path, tok, max_len, int(mc.get("edit_image_size", 336)),
                                        te_dtype, self.device, fp8)]
        from .llm_encoders import LLMTextEncoder

        enc = LLMTextEncoder(path, max_length=max_len, template=T2I_TEMPLATE, crop_start=T2I_DROP,
                             tokenizer_path=tok, dtype=te_dtype, fp8=fp8, device=self.device)

        def fn(captions):
            h, m = enc.encode(captions)
            return {"prompt_embeds": h, "prompt_embeds_mask": m.to(torch.int32)}

        return [fn]

    def _tiny_text_fn(self):
        from ..data.bucketing import seed_from_hash

        dim = self.qi_config.joint_attention_dim

        def te(captions, control_files=None):
            embs = np.zeros((len(captions), TINY_TEXT_LENGTH, dim), np.float32)
            masks = np.zeros((len(captions), TINY_TEXT_LENGTH), np.int32)
            for i, c in enumerate(captions):
                n = min(len(c) + 1, TINY_TEXT_LENGTH)
                embs[i, :n] = np.random.default_rng(seed_from_hash(c)).standard_normal((n, dim))
                masks[i, :n] = 1
            return {"prompt_embeds": torch.from_numpy(embs),
                    "prompt_embeds_mask": torch.from_numpy(masks)}

        if self.edit:
            return te
        return lambda captions: te(captions)

    # --- weights -------------------------------------------------------------

    def _keymap_config(self):
        return self.qi_config

    def keymap(self):
        """diffusers QwenImageTransformer2DModel keys <-> the port's names;
        LoRA in the ComfyUI dialect (`diffusion_model.` prefix)."""
        from .keymaps import BlockGroup, KeyMap

        linears = {
            "norm1_linear": "img_mod.1", "norm1_context_linear": "txt_mod.1",
            "attn_to_q": "attn.to_q", "attn_to_k": "attn.to_k", "attn_to_v": "attn.to_v",
            "attn_add_q": "attn.add_q_proj", "attn_add_k": "attn.add_k_proj",
            "attn_add_v": "attn.add_v_proj", "attn_to_out": "attn.to_out.0",
            "attn_to_add_out": "attn.to_add_out",
            "ff_in": "img_mlp.net.0.proj", "ff_out": "img_mlp.net.2",
            "ff_context_in": "txt_mlp.net.0.proj", "ff_context_out": "txt_mlp.net.2",
        }
        norms = {"attn_norm_q": "attn.norm_q", "attn_norm_k": "attn.norm_k",
                 "attn_norm_added_q": "attn.norm_added_q",
                 "attn_norm_added_k": "attn.norm_added_k"}
        return KeyMap(
            blocks=[BlockGroup("blocks", "transformer_blocks", "num_layers",
                               linears=linears, norms=norms)],
            top_linears={
                "img_in": "img_in", "txt_in": "txt_in",
                "time_text_embed/linear_1": "time_text_embed.timestep_embedder.linear_1",
                "time_text_embed/linear_2": "time_text_embed.timestep_embedder.linear_2",
                "norm_out_linear": "norm_out.linear", "proj_out": "proj_out",
            },
            top_norms={"txt_norm": "txt_norm"},
            lora_prefix="diffusion_model.",
        )

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The pretrained transformer (model.transformer_path, or
        <diffusers_path>/transformer) as a state dict of the port's names.
        The model is rebuilt on the checkpoint's layout (block count,
        heads, widths) first; a key the keymap does not take raises."""
        from .keymaps import (keymap_to_state_dict, layout_override, load_sd_for_pipeline,
                              strip_known_prefixes)

        sd = load_sd_for_pipeline(self, ("transformer_path", "diffusers_path"))
        layout = layout_override(self.model_config, qwen_checkpoint_layout(
            strip_known_prefixes(sd, self.keymap())))
        if any(getattr(self.qi_config, k) != v for k, v in layout.items()):
            self.qi_config = self._build_config(layout)
            with torch.device("meta"):
                self.model = QwenImageTransformer(self.qi_config)
        return keymap_to_state_dict(sd, self.keymap(), self.qi_config)


class QwenEditTextEncoder:
    """Qwen-Image-Edit's text function: each control image (resized to
    edit_image_size, a multiple of 28) goes through the Qwen2.5-VL vision
    tower; its merged tokens replace the <|image_pad|> run of the templated
    prompt, the decoder runs on those embeddings with the multimodal RoPE
    ids, and the first 64 rows are dropped. fn(captions, control_files) ->
    {"prompt_embeds", "prompt_embeds_mask"} f32 / int32 CPU tensors."""

    def __init__(self, path: str, tokenizer_path: str, max_length: int, image_size: int,
                 dtype, device, fp8: bool = False):
        assert image_size % 28 == 0, "edit_image_size must be a multiple of 28"
        self.path, self.tokenizer_path, self.max_length = path, tokenizer_path, max_length
        self.image_size, self.dtype, self.device, self.fp8 = image_size, dtype, device, fp8
        self.lm = None

    def _load(self):
        if self.lm is not None:
            return
        from transformers import AutoTokenizer

        from .llm_encoders import load_causal_lm
        from .vision_encoders import QwenVLVisionConfig, QwenVLVisionTower, convert_hf_qwen_vision

        self.lm, _, hf_cfg, sd = load_causal_lm(self.path, self.dtype, self.device,
                                                "model.language_model.", self.fp8)
        vcfg = QwenVLVisionConfig.from_hf_config(hf_cfg, dtype=self.dtype)
        vprefix = "visual." if any(k.startswith("visual.") for k in sd) else "model.visual."
        with torch.device("meta"):
            tower = QwenVLVisionTower(vcfg)
        tower = tower.to_empty(device=self.device)
        tower.load_state_dict({k: v.to(self.dtype)
                               for k, v in convert_hf_qwen_vision(sd, vcfg, vprefix).items()})
        self.tower = tower.eval().requires_grad_(False)
        self.tokenizer = AutoTokenizer.from_pretrained(self.tokenizer_path)
        self.image_token_id = int(hf_cfg.get("image_token_id", 151655))
        self.grid = (1, self.image_size // 14, self.image_size // 14)
        self.n_img = self.grid[1] * self.grid[2] // 4

    def encode_images(self, images: List[np.ndarray]):
        """[C, H, W] images in [-1, 1] at edit_image_size -> the tower's
        merged tokens, one [n_img, 3584] tensor each."""
        from .vision_encoders import image_to_qwen_patches

        self._load()
        return [self.tower(torch.from_numpy(image_to_qwen_patches(img)[0]).to(self.device),
                           (self.grid,)) for img in images]

    @torch.no_grad()
    def encode(self, captions: List[str], images: List[np.ndarray]):
        from .vision_encoders import qwen_vl_rope_index

        self._load()
        texts = [EDIT_TEMPLATE.format(c).replace("<|image_pad|>", "<|image_pad|>" * self.n_img)
                 for c in captions]
        tok = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=self.max_length + EDIT_DROP + self.n_img,
                             return_tensors="np")
        embeds, masks = [], []
        for i, vis in enumerate(self.encode_images(images)):
            ids = tok["input_ids"][i]
            emb = self.lm.token_embedding(torch.from_numpy(ids).to(self.device)).to(self.dtype)
            emb[torch.from_numpy(np.nonzero(ids == self.image_token_id)[0]).to(self.device)] = \
                vis.to(emb.dtype)
            pos = qwen_vl_rope_index(ids, self.image_token_id, self.grid, merge=2)
            mask = torch.from_numpy(tok["attention_mask"][i])
            h, _ = self.lm(None, mask[None].to(self.device), input_embeds=emb[None],
                           position_ids=torch.from_numpy(pos)[None].to(self.device))
            embeds.append(h[0, EDIT_DROP:].float().cpu())
            masks.append(mask[EDIT_DROP:].to(torch.int32))
        return {"prompt_embeds": torch.stack(embeds), "prompt_embeds_mask": torch.stack(masks)}

    def __call__(self, captions, control_files):
        from PIL import Image

        images = []
        for f in control_files:
            img = Image.open(f).convert("RGB").resize((self.image_size, self.image_size),
                                                      Image.BICUBIC)
            images.append(np.asarray(img, np.float32).transpose(2, 0, 1) / 127.5 - 1.0)
        return self.encode(captions, images)
