"""HunyuanImage-2.1 (17 B): the transformer and its pipeline.

Counterpart of diffusion_pipe_tpu/models/hunyuan_image.py. The blocks are
HunyuanVideo's (models/hunyuan_video_model.py: the token refiner, the
double and single blocks, the head); around them, 2-D latents of 64
channels from the 32x VAE, patch (1, 1), 3,584 wide (28 heads of 128), 20 +
40 blocks, RoPE (64, 64) over the (h, w) grid; the conditioning vector is
the timestep's embedding alone (no pooled text, no guidance). The text
carry is [byT5, Qwen] under one key mask: the glyph byT5 states of the
caption's quoted spans through the byt5_in mapper (affine LayerNorm, fc1,
GELU, fc2, GELU, fc3: 1,472 -> 2,048 -> 2,048 -> 3,584), then
Qwen2.5-VL's hidden_states[-3] through the token refiner.

The byt5_in GELU is the JAX module's tanh form (byt5_gelu = "tanh"); the
published ByT5Mapper reads as the exact nn.GELU() ("none"), a reading left
to check against a checkpoint (ROADMAP C).

The pipeline: rectified flow with t scaled by 1,000, the target noise -
latents; the keys are hyimage's, and a checkpoint's layout is read from
them (a guidance_in or meanflow checkpoint raises, naming the keys the
model does not take). The LoRA goes out in the ComfyUI dialect
(`diffusion_model.` prefix, `_attn.qkv`, `_mlp.0`, `_mod.lin.`), which the
import and the checkpoint loader also take.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .flux import resize_mask_to_latents
from .hunyuan_video import (build_mm_config, load_mm_checkpoint, mm_checkpoint_layout,
                            mm_keymap)
from .hunyuan_video_model import (HunyuanStacks, MLPEmbedder, grid_ids, plain_dense,
                                  unpatchify)
from .layers import (init_module_weights, layer_norm, lecun_normal_, rope_frequencies,
                     sinusoidal_timestep_embedding)


@dataclasses.dataclass(frozen=True)
class HunyuanImageConfig:
    in_channels: int = 64
    out_channels: int = 64
    patch_size: Tuple[int, int] = (1, 1)
    num_attention_heads: int = 28
    attention_head_dim: int = 128
    num_layers: int = 20
    num_single_layers: int = 40
    mlp_ratio: float = 4.0
    text_dim: int = 3584          # Qwen2.5-VL hidden
    byt5_dim: int = 1472          # byT5-small hidden
    byt5_mapper_dim: int = 2048
    byt5_gelu: str = "tanh"       # F.gelu's `approximate` in byt5_in
    rope_axes_dim: Tuple[int, ...] = (64, 64)
    rope_theta: float = 256.0
    refiner_layers: int = 2
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

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @staticmethod
    def tiny(**kw) -> "HunyuanImageConfig":
        """The JAX HunyuanImageConfig.tiny sizes."""
        d = dict(in_channels=8, out_channels=8, num_attention_heads=4, attention_head_dim=16,
                 num_layers=2, num_single_layers=2, text_dim=32, byt5_dim=16,
                 byt5_mapper_dim=24, rope_axes_dim=(8, 8), refiner_layers=1,
                 dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return HunyuanImageConfig(**d)


class PatchEmbed2d(nn.Module):
    """hyimage's img_in: Conv2d with kernel = stride = patch over [B, C, H, W]
    -> tokens [B, (H/ph)(W/pw), out], computed as one product of the
    flattened patches with the flattened kernel."""

    def __init__(self, cfg: HunyuanImageConfig):
        super().__init__()
        self.patch, self.dtype = tuple(cfg.patch_size), cfg.dtype
        self.weight = nn.Parameter(torch.empty(cfg.hidden_size, cfg.in_channels, *self.patch,
                                               dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.empty(cfg.hidden_size, dtype=cfg.param_dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        self.bias.zero_()

    def forward(self, x):
        b, c, h, w = x.shape
        ph, pw = self.patch
        x = x.reshape(b, c, h // ph, ph, w // pw, pw).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, -1, c * ph * pw)
        return F.linear(x.to(self.dtype), self.weight.flatten(1).to(self.dtype),
                        self.bias.to(self.dtype))


class ByT5Mapper(nn.Module):
    """byt5_in: affine LayerNorm, fc1, GELU, fc2, GELU, fc3 (no adapter)."""

    def __init__(self, cfg: HunyuanImageConfig):
        super().__init__()
        self.cfg = cfg
        self.layernorm_scale = nn.Parameter(torch.empty(cfg.byt5_dim, dtype=cfg.param_dtype))
        self.layernorm_bias = nn.Parameter(torch.empty(cfg.byt5_dim, dtype=cfg.param_dtype))
        self.fc1 = plain_dense(cfg, cfg.byt5_dim, cfg.byt5_mapper_dim)
        self.fc2 = plain_dense(cfg, cfg.byt5_mapper_dim, cfg.byt5_mapper_dim)
        self.fc3 = plain_dense(cfg, cfg.byt5_mapper_dim, cfg.hidden_size)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.layernorm_scale.fill_(1.0)
        self.layernorm_bias.zero_()

    def forward(self, x):
        act = self.cfg.byt5_gelu
        y = layer_norm(x.to(self.cfg.dtype), scale=self.layernorm_scale,
                       bias=self.layernorm_bias)
        y = F.gelu(self.fc1(y), approximate=act)
        return self.fc3(F.gelu(self.fc2(y), approximate=act))


class HunyuanImageTransformer(HunyuanStacks):
    def __init__(self, cfg: HunyuanImageConfig):
        super().__init__()
        self.cfg = cfg
        self.img_in = PatchEmbed2d(cfg)
        self.time_in = MLPEmbedder(cfg, 256)
        self.byt5_in = ByT5Mapper(cfg)
        ph, pw = cfg.patch_size
        self._init_stacks(cfg, cfg.text_dim, cfg.out_channels * ph * pw)

    def forward(self, x, t, text_states, text_mask, byt5_states, byt5_mask):
        """x [B, 64, H, W], t [B] in [0, 1,000], text_states [B, S, 3,584]
        (Qwen2.5-VL, cropped) with text_mask [B, S], byt5_states [B, Sb,
        1,472] with byt5_mask [B, Sb] -> [B, 64, H, W] f32."""
        cfg = self.cfg
        ph, pw = cfg.patch_size
        grid = (x.shape[2] // ph, x.shape[3] // pw)
        img = self.img_in(x)
        temb = sinusoidal_timestep_embedding(t, 256)
        vec = self.time_in(temb.to(cfg.dtype))
        txt = torch.cat([self.byt5_in(byt5_states),
                         self.refine_text(text_states, text_mask, temb)], dim=1)
        mask = torch.cat([byt5_mask.to(torch.int32), text_mask.to(torch.int32)], dim=1)
        cos, sin = rope_frequencies(grid_ids(*grid, device=x.device), cfg.rope_axes_dim,
                                    cfg.rope_theta)
        img = self.run_blocks(img, txt, vec, cos, sin, mask)
        return unpatchify(self.head(img, vec), cfg.out_channels, grid, cfg.patch_size)


# the ComfyUI dialect's names -> hyimage's (the reference's
# ORIGINAL_TO_COMFYUI_LORA_MAPPING, read backwards)
COMFY_RENAMES = (("_attn.qkv", "_attn_qkv"), ("_attn.proj", "_attn_proj"),
                 ("_mlp.0", "_mlp.fc1"), ("_mlp.2", "_mlp.fc2"), ("_mod.lin.", "_mod.linear."),
                 ("modulation.lin.", "modulation.linear."))
QUOTES = (r"\"(.*?)\"", r"‘(.*?)’", r"“(.*?)”")


def hunyuan_image_keymap(cfg: HunyuanImageConfig):
    """hyimage HYImageDiffusionTransformer keys <-> the port's names; LoRA
    under `diffusion_model.` in the ComfyUI dialect."""
    top = {"time_in.linear_1": "time_in.mlp.0", "time_in.linear_2": "time_in.mlp.2",
           **{f"byt5_in.fc{i}": f"byt5_in.fc{i}" for i in (1, 2, 3)}}
    return mm_keymap(cfg, top, "diffusion_model.",
                     top_raw={"byt5_in.layernorm_scale": "byt5_in.layernorm.weight",
                              "byt5_in.layernorm_bias": "byt5_in.layernorm.bias"},
                     lora_renames=COMFY_RENAMES)


def hunyuan_image_layout(sd) -> Dict[str, Any]:
    """mm_checkpoint_layout with the byT5 mapper's widths."""
    from .hunyuan_video import _shape

    layout = mm_checkpoint_layout(sd)
    mapper, byt5 = _shape(sd, "byt5_in.fc1.weight")
    layout.update(byt5_dim=byt5, byt5_mapper_dim=mapper)
    return layout


def byt5_prompts(captions):
    """The glyph branch's input: each caption's quoted spans ("...", ‘...’,
    “...”) as `Text "<span>". ` joined, and the indices of the captions
    without one (their states are zeroed)."""
    formatted, empty = [], []
    for i, prompt in enumerate(captions):
        spans = [s for pat in QUOTES for s in re.findall(pat, prompt)]
        if not spans:
            empty.append(i)
        formatted.append("".join(f'Text "{s}". ' for s in spans))
    return formatted, empty


def byt5_text_fn(encoder):
    """The glyph branch's caching function over a byT5 encoder (an
    HFTextEncoder "t5"): captions -> {byt5_states [B, 128, 1,472] f32, zero
    for a caption without a quoted span; byt5_mask int32}."""

    def fn(captions):
        formatted, empty = byt5_prompts(captions)
        h, m = encoder.encode(formatted, return_mask=True)
        h[empty] = 0.0
        return {"byt5_states": h, "byt5_mask": m.to(torch.int32)}

    return fn


@register_model("hunyuan_image")
class HunyuanImagePipeline(BasePipeline):
    name = "hunyuan_image"
    text_keys = ("text_states", "text_mask", "byt5_states", "byt5_mask")

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.hi_config = self._build_config()
        with torch.device("meta"):
            self.model = HunyuanImageTransformer(self.hi_config)

    def _build_config(self, layout: Optional[Dict] = None) -> HunyuanImageConfig:
        return build_mm_config(self, HunyuanImageConfig, layout)

    def init_params(self, generator: torch.Generator) -> None:
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    # --- training -----------------------------------------------------------

    def _text(self, batch, b: int):
        dt = self.hi_config.dtype
        return dict(text_states=batch["text_states"].to(self.device, dt),
                    text_mask=batch["text_mask"].to(self.device).reshape(b, -1),
                    byt5_states=batch["byt5_states"].to(self.device, dt),
                    byt5_mask=batch["byt5_mask"].to(self.device).reshape(b, -1))

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 64, H, W] (or [B, 64, 1, H, W]), the cached
        Qwen and byT5 states with their masks, optional mask [B, Hm, Wm]
        (resized to [B, 1, H, W]). noise and t are drawn from `generator`
        unless given."""
        latents = batch["latents"].to(self.device, torch.float32)
        if latents.dim() == 5:
            latents = latents[:, :, 0]
        b, _, h, w = latents.shape
        mask = batch.get("mask")
        if mask is not None:
            mask = resize_mask_to_latents(mask.to(self.device), h, w, 1)
        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator, quantile=timestep_quantile,
                                 image_seq_len=(h // 2) * (w // 2), device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1)
        x_t = (1.0 - t_exp) * latents + t_exp * noise
        inputs = dict(x=x_t.to(self.hi_config.dtype), t=t * 1000.0, **self._text(batch, b))
        return inputs, noise - latents, mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, noise: Optional[torch.Tensor] = None, **embeds):
        """Euler flow sampling through the training forward: latents [B, 64,
        height / 32, width / 32] f32, sigmas shifted by model.shift."""
        from ..training.sampling import euler_flow_sample

        b = embeds["text_states"].shape[0]
        text = self._text(embeds, b)
        cfg = self.hi_config

        def vel(x, t):
            return self.forward(dict(x=x.to(cfg.dtype), t=t * 1000.0, **text))

        return euler_flow_sample(vel, (b, cfg.in_channels, height // 32, width // 32), generator,
                                 num_steps=num_steps, guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift"), noise=noise,
                                 device=self.device)

    # --- caching encoders ----------------------------------------------------

    def _load_vae(self):
        return self._load_generic_image_vae(self.hi_config.in_channels, 32)

    def get_call_vae_fn(self):
        """fn(pixels) -> {"latents": [B, 64, H / 32, W / 32]}: the 32x VAE of
        model.vae_path through the AutoencoderKL loader, its depth and
        widths from the shapes (under `_tiny` a seeded 32x KL VAE at the tiny
        latent width)."""
        return self._generic_image_vae_fn(self.hi_config.in_channels, 32)

    def get_call_text_encoder_fns(self):
        """[Qwen fn, byT5 fn], each captions -> {name: CPU tensor}:
        Qwen2.5-VL's hidden_states[-3] under the template, its first
        crop_start (34) rows dropped, max_sequence_length (966) rows
        ({text_states} f32, {text_mask} int32); byT5-small's states of the
        quoted spans ({byt5_states} [B, 128, 1,472], zero for a caption
        without one, {byt5_mask}). Under `_tiny`, the JAX hook's draws (8
        Qwen rows and 4 byT5 rows, all valid)."""
        from ..common import dtype_from_string
        from .llm_encoders import LLMTextEncoder
        from .text_encoders import HFTextEncoder

        mc = self.model_config
        if mc.get("_tiny", False):
            return [self._tiny_text_fn]
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        kw = dict(device=self.device, dtype=te_dtype)
        template = mc.get(
            "prompt_template",
            "<|im_start|>system\nDescribe the image by detailing the color, shape, size, "
            "texture, quantity, text, spatial relationships of the objects and "
            "background:<|im_end|>\n<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n")
        crop = int(mc.get("crop_start", 34))
        qwen = LLMTextEncoder(mc["text_encoder_path"],
                              max_length=int(mc.get("max_sequence_length", 1000 - crop)),
                              template=template, crop_start=crop, hidden_layer=-3, **kw)
        byt5 = HFTextEncoder("t5", mc["byt5_path"], max_length=128, **kw)

        def qwen_fn(captions):
            h, m = qwen.encode(captions)
            return {"text_states": h, "text_mask": m.to(torch.int32)}

        return [qwen_fn, byt5_text_fn(byt5)]

    def _tiny_text_fn(self, captions):
        from ..data.bucketing import seed_from_hash

        cfg = self.hi_config
        out = {"text_states": [], "byt5_states": []}
        for c in captions:
            r = np.random.default_rng(seed_from_hash(c))
            out["text_states"].append(r.standard_normal((8, cfg.text_dim)).astype(np.float32))
            out["byt5_states"].append(r.standard_normal((4, cfg.byt5_dim)).astype(np.float32))
        out = {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}
        n = len(captions)
        return dict(out, text_mask=torch.ones((n, 8), dtype=torch.int32),
                    byt5_mask=torch.ones((n, 4), dtype=torch.int32))

    # --- weights -------------------------------------------------------------

    def _keymap_config(self):
        return self.hi_config

    def keymap(self):
        return hunyuan_image_keymap(self.hi_config)

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The transformer [model] names, hyimage's or ComfyUI's key dialect,
        as the port's state dict, the model rebuilt on the checkpoint's
        layout first; a key missing or left over (guidance_in, meanflow)
        raises."""
        return load_mm_checkpoint(self, "hi_config", hunyuan_image_layout, COMFY_RENAMES)
