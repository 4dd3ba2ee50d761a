"""SD3 pipeline: training-input preparation around SD3Transformer, and what
the training driver needs of it.

Counterpart of diffusion_pipe_tpu/models/sd3.py: rectified flow with
logit-normal t (shift / flux_shift from the model config, image_seq_len
(H/2)(W/2)), the prompt assembled as the reference does it: CLIP-L and
CLIP-G hidden states side by side, zero-padded to the T5 width, then the
T5 rows after them along the sequence; pooled = CLIP-L's pooled ‖
CLIP-G's. The model takes latents [B, 16, H, W] and t * 1000. The noise
and t come from a torch.Generator or are passed in.

Caching: the 16-channel SD3 VAE (VAEConfig.sd3: scaling 1.5305, shift
0.0609, no quant conv) and three text functions: CLIP-L and bigG as the
port's clip_text towers with their projections, giving hidden_states[-2]
and the projected pooled output as diffusers' StableDiffusion3Pipeline
does (no attention mask: the towers' causal mask only), and T5 through
HFTextEncoder at max_sequence_length (256). Under `_tiny` they are seeded
draws at the JAX `_tiny` hook's sizes.

Weights: keymap() maps diffusers SD3Transformer2DModel keys
(transformer_blocks.{n-1} is final_block, pos_embed.proj is the patch
linear, LoRA under `transformer.`) and drives load_weights, the adapter
export and import and the full fine-tuning export. The layout (blocks,
heads, qk_norm, the position table's side) comes from the checkpoint at
load, or from [model]; the JAX pipeline always builds SD3-Medium's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..common import dtype_from_string
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .layers import adapter_kwargs, block_kernel_kwargs, init_module_weights, remat_spec
from .sd3_model import SD3Config, SD3Transformer

CLIP_LENGTH = 77


class CLIPPromptEncoder:
    """One of SD3's CLIP towers (the port's clip_text module, with its
    projection) and its tokenizer, from a diffusers text_encoder folder;
    captions -> (hidden_states[-2] [B, 77, width], pooled [B, proj]) f32 on
    the CPU. Loads at the first call."""

    def __init__(self, path: str, tokenizer_path: str, device):
        self.path, self.tokenizer_path, self.device = path, tokenizer_path, device
        self._model = self._tokenizer = None

    def _load(self):
        if self._model is not None:
            return
        from transformers import AutoTokenizer

        from .clip_text import CLIPTextConfig, CLIPTextModel
        from .weights import load_safetensors_dir

        jc = json.loads((Path(self.path) / "config.json").read_text())
        model = CLIPTextModel(CLIPTextConfig.from_json(jc, with_projection=True))
        sd = {k: v for k, v in load_safetensors_dir(self.path).items()
              if not k.endswith("position_ids")}
        model.load_state_dict(sd)
        self._model = model.to(self.device).eval().requires_grad_(False)
        self._tokenizer = AutoTokenizer.from_pretrained(self.tokenizer_path)

    @torch.no_grad()
    def __call__(self, captions):
        self._load()
        ids = self._tokenizer(captions, padding="max_length", truncation=True,
                              max_length=CLIP_LENGTH, return_tensors="pt")["input_ids"]
        hidden, pooled = self._model(ids.to(self.device))
        return hidden[-2].float().cpu(), pooled.float().cpu()


def merge_prompt(batch, device):
    """(prompt_embeds [B, 77 + S_t5, D_t5], pooled [B, 2048]) f32: CLIP-L ‖
    CLIP-G features zero-padded to the T5 width, before the T5 rows."""
    clip = torch.cat([batch["prompt_embed"], batch["prompt_2_embed"]], dim=-1)
    t5 = batch["t5_prompt_embed"].to(device, torch.float32)
    clip = F.pad(clip.to(device, torch.float32), (0, t5.shape[-1] - clip.shape[-1]))
    pooled = torch.cat([batch["pooled_prompt_embed"], batch["pooled_prompt_2_embed"]], dim=-1)
    return torch.cat([clip, t5], dim=-2), pooled.to(device, torch.float32)


SD3_LAYOUT_KEYS = ("num_layers", "num_attention_heads", "qk_norm", "pos_embed_max_size")


def sd3_checkpoint_layout(sd, passthrough, head_dim: int = 64) -> Dict[str, Any]:
    """The layout of a (prefix-stripped) diffusers SD3 / SD3.5 checkpoint:
    its block count, heads (the width over the head dim, 64 in the
    family), qk_norm (norm_q weights present) and the position table's side (from
    pos_embed.pos_embed, kept in `passthrough`, when the file has it).
    SD3.5 Medium's second self-attention (attn2, MMDiT-X) is not built by
    either package: NotImplementedError names its keys."""
    from .keymaps import count_blocks

    attn2 = sorted(k for k in sd if ".attn2." in k)
    if attn2:
        raise NotImplementedError(f"SD3.5 MMDiT-X blocks (attn2) are not ported: "
                                  f"{len(attn2)} keys, e.g. {attn2[:4]}")
    layout = dict(num_layers=count_blocks(sd, "transformer_blocks"),
                  num_attention_heads=sd["context_embedder.weight"].shape[0] // head_dim,
                  qk_norm="transformer_blocks.0.attn.norm_q.weight" in sd)
    table = passthrough.get("pos_embed.pos_embed")
    if table is not None:
        layout["pos_embed_max_size"] = int(round(table.shape[1] ** 0.5))
    return layout


@register_model("sd3", "sd3.5")
class SD3Pipeline(BasePipeline):
    name = "sd3"
    # the text cache's encoder tag: the port's CLIP functions give the
    # projected pooled output without the tokenizer's mask, the JAX
    # package's the unprojected one with it, under the same cache folder
    text_cache_tag = "clip-projected-pooled-unmasked"

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.sd3_config = self._build_config()
        with torch.device("meta"):
            self.model = SD3Transformer(self.sd3_config)

    def _build_config(self, layout: Optional[Dict[str, Any]] = None) -> SD3Config:
        """SD3-Medium's layout (24 blocks, 24 heads, no qk_norm, a 192 x
        192 position table), or [model]'s num_layers, num_attention_heads,
        qk_norm and pos_embed_max_size, or `layout` (what load_weights read
        from the checkpoint: SD3.5 Large has 38 blocks, 38 heads and
        qk_norm)."""
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype, remat=remat_spec(self.config),
                                      **block_kernel_kwargs(mc))
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        kwargs.update({k: mc[k] for k in SD3_LAYOUT_KEYS if mc.get(k) is not None})
        kwargs.update(layout or {})
        if mc.get("_tiny", False):
            return SD3Config.tiny(**kwargs)
        return SD3Config(**kwargs)

    def init_params(self, generator: torch.Generator) -> None:
        """Every weight on the pipeline's device, filled as the JAX package
        initialises it (lecun-normal kernels, zero biases, LoRA A uniform
        and B zero, norm scales one)."""
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 16, H, W], prompt_embed / prompt_2_embed [B, 77,
        768 / 1280], pooled_prompt_embed / pooled_prompt_2_embed [B, 768 /
        1280], t5_prompt_embed [B, S, 4096], optional mask [B, Hm, Wm].
        noise and t are drawn from `generator` unless given."""
        latents = batch["latents"].to(self.device, torch.float32)
        b, _, h, w = latents.shape
        prompt_embeds, pooled = merge_prompt(batch, self.device)
        mask = batch.get("mask")
        if mask is not None:
            mask = F.interpolate(mask.to(self.device).float()[:, None], size=(h, w),
                                 mode="nearest-exact")
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
        model_inputs = dict(hidden_states=x_t, timestep=t * 1000.0,
                            encoder_hidden_states=prompt_embeds, pooled_projections=pooled)
        return model_inputs, noise - latents, mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, noise: Optional[torch.Tensor] = None, **embeds):
        """Euler flow sampling through the training forward: latents [B, 16,
        height/8, width/8] f32 from `noise` or the generator's N(0, 1),
        model.shift (default 3.0) as the sigmas' shift."""
        from ..training.sampling import euler_flow_sample

        prompt_embeds, pooled = merge_prompt(embeds, self.device)
        b = prompt_embeds.shape[0]
        h, w = height // 8, width // 8

        def vel(x, t):
            return self.forward(dict(hidden_states=x, timestep=t * 1000.0,
                                     encoder_hidden_states=prompt_embeds,
                                     pooled_projections=pooled))

        return euler_flow_sample(vel, (b, 16, h, w), generator, num_steps=num_steps,
                                 guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift", 3.0), noise=noise,
                                 device=self.device)

    # --- caching encoders ---------------------------------------------------

    def _load_vae(self):
        """The SD3 VAE on the pipeline's device in the model dtype, frozen:
        seeded at a small width under `_tiny`, else model.vae_path (or
        diffusers_path/vae) in the diffusers layout."""
        if getattr(self, "_vae", None) is None:
            from .autoencoder_kl import AutoencoderKL, VAEConfig, convert_diffusers_vae
            from .weights import load_safetensors_dir

            mc = self.model_config
            dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
            if mc.get("_tiny", False):
                cfg = VAEConfig(latent_channels=16, block_out_channels=(8, 8, 16, 16),
                                norm_num_groups=4, layers_per_block=1, scaling_factor=1.0,
                                shift_factor=0.0, dtype=dtype)
                vae = AutoencoderKL(cfg).to(self.device)
                vae.init_weights(torch.Generator(device=self.device).manual_seed(0))
            else:
                cfg = VAEConfig.sd3(dtype=dtype)
                path = mc.get("vae_path") or str(Path(mc["diffusers_path"]) / "vae")
                sd = convert_diffusers_vae(load_safetensors_dir(path), cfg)
                with torch.device("meta"):
                    vae = AutoencoderKL(cfg)
                vae = vae.to_empty(device=self.device)
                vae.load_state_dict(sd)
            self._vae = vae.eval().requires_grad_(False)
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
        """[CLIP-L fn, CLIP-G fn, T5 fn], each captions -> {name: f32 CPU
        tensor} (see module docstring)."""
        mc = self.model_config
        cfg = self.sd3_config
        if mc.get("_tiny", False):
            from .text_encoders import seeded_draws

            def clip1(caps):
                return {"prompt_embed": seeded_draws(caps, "1", (8, 24)),
                        "pooled_prompt_embed": seeded_draws(caps, "p1", (16,))}

            def clip2(caps):
                return {"prompt_2_embed": seeded_draws(caps, "2", (8, 24)),
                        "pooled_prompt_2_embed": seeded_draws(caps, "p2", (16,))}

            def t5(caps):
                return {"t5_prompt_embed": seeded_draws(caps, "t5", (8, cfg.joint_attention_dim))}

            return [clip1, clip2, t5]

        from .text_encoders import HFTextEncoder

        base = Path(mc["diffusers_path"])
        clip_l = CLIPPromptEncoder(str(base / "text_encoder"), str(base / "tokenizer"), self.device)
        clip_g = CLIPPromptEncoder(str(base / "text_encoder_2"), str(base / "tokenizer_2"),
                                   self.device)
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        t5 = HFTextEncoder("t5", str(base / "text_encoder_3"),
                           int(mc.get("max_sequence_length", 256)),
                           tokenizer_path=str(base / "tokenizer_3"), device=self.device,
                           dtype=te_dtype)

        def clip1(caps):
            hidden, pooled = clip_l(caps)
            return {"prompt_embed": hidden, "pooled_prompt_embed": pooled}

        def clip2(caps):
            hidden, pooled = clip_g(caps)
            return {"prompt_2_embed": hidden, "pooled_prompt_2_embed": pooled}

        def t5_fn(caps):
            return {"t5_prompt_embed": t5.encode(caps)}

        return [clip1, clip2, t5_fn]

    # --- weights ------------------------------------------------------------

    def _keymap_config(self):
        return self.sd3_config

    def keymap(self):
        """diffusers SD3Transformer2DModel keys <-> the port's names: the
        last joint block (context_pre_only) is final_block and maps to
        transformer_blocks.{n-1}; LoRA under `transformer.`."""
        from .keymaps import BlockGroup, KeyMap

        cfg = self.sd3_config
        lin = {
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
        norms = {}
        if cfg.qk_norm:
            norms = {"attn_to_norm_q": "attn.norm_q", "attn_to_norm_k": "attn.norm_k",
                     "attn_add_norm_q": "attn.norm_added_q",
                     "attn_add_norm_k": "attn.norm_added_k"}
        last = f"transformer_blocks.{cfg.num_layers - 1}"
        context_out = ("attn_to_add_out", "ff_context_in", "ff_context_out")
        top_linears = {
            "timestep_embedder/linear_1": "time_text_embed.timestep_embedder.linear_1",
            "timestep_embedder/linear_2": "time_text_embed.timestep_embedder.linear_2",
            "text_embedder/linear_1": "time_text_embed.text_embedder.linear_1",
            "text_embedder/linear_2": "time_text_embed.text_embedder.linear_2",
            "context_embedder": "context_embedder",
            "norm_out_linear": "norm_out.linear",
            "proj_out": "proj_out",
            # the final joint block, context_pre_only (no to_add_out / ff_context)
            **{f"final_block/{k}": f"{last}.{v}" for k, v in lin.items() if k not in context_out},
        }
        return KeyMap(
            blocks=[BlockGroup("blocks", "transformer_blocks", "num_scan_layers",
                               linears=lin, norms=norms)],
            top_linears=top_linears,
            top_norms={f"final_block/{k}": f"{last}.{v}" for k, v in norms.items()},
            top_patch_linears={"pos_embed_proj": "pos_embed.proj"},
            patch_linear_shapes={"pos_embed_proj": (cfg.in_channels, cfg.patch_size,
                                                    cfg.patch_size)},
            lora_prefix="transformer.",
            # the fixed position table: the port computes it
            passthrough_patterns=(r"^pos_embed\.pos_embed$",),
        )

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The pretrained transformer (model.ckpt_path, transformer_path,
        single_file_path or diffusers_path/transformer; model.merge_adapters
        fused in) as a state dict of the port's names. The model is rebuilt
        on the checkpoint's layout (sd3_checkpoint_layout, checked against
        [model]'s); a key missing or left over raises KeyError naming it."""
        from .keymaps import keymap_to_state_dict, layout_override, load_sd_for_pipeline

        sd = load_sd_for_pipeline(self)
        layout = layout_override(self.model_config,
                                 sd3_checkpoint_layout(sd, getattr(self, "_passthrough_sd", {}),
                                                       self.sd3_config.attention_head_dim))
        if any(getattr(self.sd3_config, k) != v for k, v in layout.items()):
            self.sd3_config = self._build_config(layout)
            with torch.device("meta"):
                self.model = SD3Transformer(self.sd3_config)
        return keymap_to_state_dict(sd, self.keymap(), self.sd3_config)
