"""HunyuanVideo-1.5 (8.3 B): the transformer and its pipeline.

Counterpart of diffusion_pipe_tpu/models/hunyuan_video_15.py. The blocks are
HunyuanVideo's (models/hunyuan_video_model.py): double blocks alone (no
single block), the token refiner and the adaLN head. Around them:
- img_in, a patch convolution over 65 channels: the noisy latents, as many
  zero conditioning latents and one zero mask channel;
- the conditioning vector from the timestep alone (no pooled text, no
  guidance);
- the text carry [byT5, Qwen] under one key mask: the glyph byT5 states
  through HunyuanImage-2.1's byt5_in mapper (the JAX module's tanh GELU),
  the Qwen states through the token refiner, and cond_type_embedding's row
  0 added to the text rows, row 1 to the byT5 rows;
- RoPE (16, 56, 56) at theta 256 over the (f, h, w) grid, on the image rows
  only;
- the head unflattening final_linear's rows as hyvideo does, channels first
  (the port's HunyuanVideo head; the JAX module reads them (pt, ph, pw, c),
  which interop.hunyuan_video_15_state_dict reorders).

The published defaults are the reading of the 8.3 B release: 2,048 wide (16
heads of 128), 54 double blocks, patch (1, 1, 1), 32 latent channels and
Qwen2.5-VL-7B's 3,584-wide states. The JAX defaults differ (3,072 wide, 36
blocks, patch (1, 2, 2), 2,560 text); a checkpoint's keys set the layout in
either package, so these are the smoke cell's configuration, not a
departure (ROADMAP C lists the reading as unverified).

The pipeline: rectified flow with t scaled by 1,000 and the target noise -
latents; 16x spatial and 4x temporal latents from the HunyuanVideo causal
VAE family at the checkpoint's widths (models/hunyuan_vae.py,
model.vae_temporal_downsamples and model.vae_scaling_factor as the JAX
pipeline takes them); the text through HunyuanImage-2.1's Qwen2.5-VL and
byT5 functions. Keys are the ComfyUI hyvideo-1.5 dialect under
`diffusion_model.`, the LoRA too; the checkpoint's vision_in tower (wired
but never fed in training) passes through to a full export.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..common import dtype_from_string
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .flux import resize_mask_to_latents
from .hunyuan_image import ByT5Mapper
from .hunyuan_video import HunyuanVAEMixin, _shape, build_mm_config, load_mm_checkpoint
from .hunyuan_video_model import HunyuanStacks, MLPEmbedder, grid_ids, unpatchify
from .layers import (PatchEmbed3d, init_module_weights, rope_frequencies,
                     sinusoidal_timestep_embedding)

# [model] knobs that set the transformer's size (the other sizes come from a
# checkpoint's keys)
SIZE_KNOBS = ("num_layers",)


@dataclasses.dataclass(frozen=True)
class HunyuanVideo15Config:
    in_channels: int = 65         # noisy latents, zero conditioning latents, zero mask
    out_channels: int = 32
    patch_size: Tuple[int, int, int] = (1, 1, 1)
    num_attention_heads: int = 16
    attention_head_dim: int = 128
    num_layers: int = 54          # double blocks only
    num_single_layers: int = 0
    mlp_ratio: float = 4.0
    text_dim: int = 3584          # Qwen2.5-VL-7B hidden
    byt5_dim: int = 1472
    byt5_mapper_dim: int = 2048
    byt5_gelu: str = "tanh"
    rope_axes_dim: Tuple[int, ...] = (16, 56, 56)
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
    def latent_channels(self) -> int:
        return self.out_channels

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @staticmethod
    def tiny(**kw) -> "HunyuanVideo15Config":
        """The JAX HunyuanVideo15Config.tiny sizes (its patch (1, 2, 2))."""
        d = dict(in_channels=9, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=4,
                 attention_head_dim=16, num_layers=2, text_dim=32, byt5_dim=16,
                 byt5_mapper_dim=24, rope_axes_dim=(4, 6, 6), refiner_layers=1,
                 dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return HunyuanVideo15Config(**d)


class CondTypeEmbedding(nn.Module):
    """cond_type_embedding: row 0 for the text rows, row 1 for the byT5 rows."""

    def __init__(self, cfg: HunyuanVideo15Config):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(2, cfg.hidden_size, dtype=cfg.param_dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        tmp = torch.randn(self.weight.shape, generator=generator, dtype=torch.float32,
                          device=self.weight.device)
        self.weight.copy_(tmp.mul_(self.weight.shape[1] ** -0.5))


class HunyuanVideo15Transformer(HunyuanStacks):
    def __init__(self, cfg: HunyuanVideo15Config):
        super().__init__()
        self.cfg = cfg
        self.img_in = PatchEmbed3d(cfg.in_channels, cfg.hidden_size, cfg.patch_size,
                                   dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.time_in = MLPEmbedder(cfg, 256)
        self.byt5_in = ByT5Mapper(cfg)
        self.cond_type_embedding = CondTypeEmbedding(cfg)
        self._init_stacks(cfg, cfg.text_dim, cfg.out_channels * math.prod(cfg.patch_size))

    def forward(self, x, t, text_states, text_mask, byt5_states, byt5_mask):
        """x [B, 65, F, H, W] (latents, zero conditioning, zero mask), t [B] in
        [0, 1,000], text_states [B, S, text_dim] with text_mask [B, S],
        byt5_states [B, Sb, 1,472] with byt5_mask [B, Sb] -> [B, 32, F, H, W]
        f32."""
        cfg = self.cfg
        _, _, f, h, w = x.shape
        pt, ph, pw = cfg.patch_size
        grid = (f // pt, h // ph, w // pw)
        img = self.img_in(x)
        temb = sinusoidal_timestep_embedding(t, 256)
        vec = self.time_in(temb.to(cfg.dtype))
        types = self.cond_type_embedding.weight.to(cfg.dtype)
        txt = self.refine_text(text_states, text_mask, temb) + types[0]
        glyph = self.byt5_in(byt5_states) + types[1]
        mask = torch.cat([byt5_mask.to(torch.int32), text_mask.to(torch.int32)], dim=1)
        cos, sin = rope_frequencies(grid_ids(*grid, device=x.device), cfg.rope_axes_dim,
                                    cfg.rope_theta)
        img = self.run_blocks(img, torch.cat([glyph, txt], dim=1), vec, cos, sin, mask)
        return unpatchify(self.head(img, vec), cfg.out_channels, grid, cfg.patch_size)


def hunyuan_video_15_keymap(cfg: HunyuanVideo15Config):
    """ComfyUI hyvideo-1.5 keys <-> the port's names (the JAX keymap's): the
    double blocks' `img_mod.lin`, `img_attn.qkv`, `img_mlp.0`, q / k norms
    `img_attn.norm.query_norm.scale`; `time_in.in_layer`, txt_in's refiner,
    byt5_in and cond_type_embedding; LoRA under `diffusion_model.`;
    vision_in.* passes through."""
    from .keymaps import BlockGroup, KeyMap

    top_linears = {
        "time_in.linear_1": "time_in.in_layer", "time_in.linear_2": "time_in.out_layer",
        "txt_in_proj": "txt_in.input_embedder",
        "refiner_t_embed.linear_1": "txt_in.t_embedder.mlp.0",
        "refiner_t_embed.linear_2": "txt_in.t_embedder.mlp.2",
        "refiner_c_embed.linear_1": "txt_in.c_embedder.linear_1",
        "refiner_c_embed.linear_2": "txt_in.c_embedder.linear_2",
        **{f"byt5_in.fc{i}": f"byt5_in.fc{i}" for i in (1, 2, 3)},
        "final_linear": "final_layer.linear", "final_mod": "final_layer.adaLN_modulation.1",
    }
    top_raw = {"byt5_in.layernorm_scale": "byt5_in.layernorm.weight",
               "byt5_in.layernorm_bias": "byt5_in.layernorm.bias",
               "cond_type_embedding.weight": "cond_type_embedding.weight"}
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
    linears = {f"{s}_{ours}": f"{s}_{theirs}" for s in ("img", "txt")
               for ours, theirs in (("mod", "mod.lin"), ("attn_qkv", "attn.qkv"),
                                    ("attn_proj", "attn.proj"), ("mlp_fc1", "mlp.0"),
                                    ("mlp_fc2", "mlp.2"))}
    norms = {f"{s}_attn_{p}_norm": f"{s}_attn.norm.{n}_norm" for s in ("img", "txt")
             for p, n in (("q", "query"), ("k", "key"))}
    return KeyMap(
        blocks=[BlockGroup("double_blocks", "double_blocks", "num_layers", linears=linears,
                           norms=norms, norm_suffix="scale")],
        top_linears=top_linears, top_raw=top_raw, top_convs={"img_in": "img_in.proj"},
        lora_prefix="diffusion_model.", passthrough_patterns=(r"^vision_in\.",))


def hunyuan_video_15_layout(sd) -> Dict[str, Any]:
    """What a (prefix-stripped) hyvideo-1.5 checkpoint holds: the double and
    refiner block counts, the width and heads (the head dim from the q
    norm), the MLP ratio, img_in's channels and patch, the output channels,
    the text width and the byT5 mapper's widths."""
    from .keymaps import count_blocks

    dim, in_ch, *patch = _shape(sd, "img_in.proj.weight")
    head = _shape(sd, "double_blocks.0.img_attn.norm.query_norm.scale")[0]
    mapper, byt5 = _shape(sd, "byt5_in.fc1.weight")
    return dict(num_layers=count_blocks(sd, "double_blocks"),
                refiner_layers=count_blocks(sd, "txt_in.individual_token_refiner.blocks"),
                num_attention_heads=dim // head, attention_head_dim=head,
                mlp_ratio=_shape(sd, "double_blocks.0.img_mlp.0.weight")[0] / dim,
                in_channels=in_ch, patch_size=tuple(patch),
                out_channels=_shape(sd, "final_layer.linear.weight")[0] // math.prod(patch),
                text_dim=_shape(sd, "txt_in.input_embedder.weight")[1],
                byt5_dim=byt5, byt5_mapper_dim=mapper)


@register_model("hunyuan_video_15", "hunyuan_video_1.5")
class HunyuanVideo15Pipeline(HunyuanVAEMixin, BasePipeline):
    name = "hunyuan_video_1.5"
    framerate = 24
    text_keys = ("text_states", "text_mask", "byt5_states", "byt5_mask")

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.hv15_config = self._build_config()
        with torch.device("meta"):
            self.model = HunyuanVideo15Transformer(self.hv15_config)

    def _build_config(self, layout: Optional[Dict] = None) -> HunyuanVideo15Config:
        return build_mm_config(self, HunyuanVideo15Config, layout, knobs=SIZE_KNOBS)

    def init_params(self, generator: torch.Generator) -> None:
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    # --- training -----------------------------------------------------------

    def _text(self, batch, b: int):
        dt = self.hv15_config.dtype
        return dict(text_states=batch["text_states"].to(self.device, dt),
                    text_mask=batch["text_mask"].to(self.device).reshape(b, -1),
                    byt5_states=batch["byt5_states"].to(self.device, dt),
                    byt5_mask=batch["byt5_mask"].to(self.device).reshape(b, -1))

    @staticmethod
    def model_input(x_t: torch.Tensor) -> torch.Tensor:
        """t2v: [x_t, zero conditioning latents, a zero mask channel]."""
        b, _, f, h, w = x_t.shape
        return torch.cat([x_t, torch.zeros_like(x_t), x_t.new_zeros((b, 1, f, h, w))], dim=1)

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 32, F, H, W] (or [B, 32, H, W]), the cached Qwen
        and byT5 states with their masks, optional mask [B, Hm, Wm] (resized
        to [B, 1, 1, H, W]). noise and t are drawn from `generator` unless
        given."""
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
        inputs = dict(x=self.model_input(x_t).to(self.hv15_config.dtype), t=t * 1000.0,
                      **self._text(batch, b))
        return inputs, noise - latents, mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, num_frames: int = 1,
               noise: Optional[torch.Tensor] = None, **embeds):
        """Euler flow sampling through the training forward: latents [B, 32,
        1 + (num_frames - 1) // 4, height / 16, width / 16] f32, sigmas
        shifted by model.shift."""
        from ..training.sampling import euler_flow_sample

        b = embeds["text_states"].shape[0]
        text = self._text(embeds, b)
        cfg = self.hv15_config
        f = max(1, (int(num_frames) - 1) // 4 + 1)

        def vel(x, t):
            return self.forward(dict(x=self.model_input(x).to(cfg.dtype), t=t * 1000.0, **text))

        return euler_flow_sample(vel, (b, cfg.latent_channels, f, height // 16, width // 16),
                                 generator, num_steps=num_steps, guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift"), noise=noise,
                                 device=self.device)

    # --- caching encoders ----------------------------------------------------

    def _load_vae(self):
        """The causal 3D VAE on the pipeline's device in the model dtype,
        frozen: under `_tiny` a seeded one at 16x spatial (five blocks) and
        the model's latent width; else load_hunyuan_vae of model.vae_path,
        4x in time unless model.vae_temporal_downsamples says otherwise,
        latents scaled by model.vae_scaling_factor (1.0)."""
        if getattr(self, "_vae", None) is None:
            from .hunyuan_vae import HunyuanVAE, HunyuanVAEConfig, load_hunyuan_vae

            mc = self.model_config
            dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
            z = self.hv15_config.latent_channels
            if mc.get("_tiny", False):
                vae = HunyuanVAE(HunyuanVAEConfig.tiny(
                    latent_channels=z, block_out_channels=(8, 16, 16, 16, 16), dtype=dtype))
                vae = vae.to(self.device)
                vae.init_weights(torch.Generator(device=self.device).manual_seed(0))
            else:
                vae = load_hunyuan_vae(
                    mc["vae_path"], dtype=dtype, device=self.device,
                    temporal_downsamples=int(mc.get("vae_temporal_downsamples") or 2),
                    scaling_factor=float(mc.get("vae_scaling_factor", 1.0)))
                if vae.config.latent_channels != z:
                    raise ValueError(f"VAE latent width {vae.config.latent_channels} != model {z}")
            self._vae = vae.eval().requires_grad_(False)
        return self._vae

    def get_call_text_encoder_fns(self):
        """HunyuanImage-2.1's [Qwen fn, byT5 fn] (the JAX pipeline borrows
        them; template, crop and hidden layer included). Under `_tiny`, the
        JAX hook's draws (8 Qwen rows and 4 byT5 rows, all valid)."""
        from .hunyuan_image import HunyuanImagePipeline

        if self.model_config.get("_tiny", False):
            return [self._tiny_text_fn]
        return HunyuanImagePipeline.get_call_text_encoder_fns(self)

    def _tiny_text_fn(self, captions):
        from ..data.bucketing import seed_from_hash

        cfg = self.hv15_config
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
        return self.hv15_config

    def keymap(self):
        return hunyuan_video_15_keymap(self.hv15_config)

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The transformer [model] names (ComfyUI hyvideo-1.5 keys) as the
        port's state dict, the model rebuilt on the checkpoint's layout first;
        a key missing or left over raises (vision_in.* passes through)."""
        return load_mm_checkpoint(self, "hv15_config", hunyuan_video_15_layout)
