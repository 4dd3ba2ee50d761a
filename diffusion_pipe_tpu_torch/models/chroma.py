"""Chroma pipeline: training-input preparation around ChromaTransformer, and
what the training driver needs of it.

Counterpart of diffusion_pipe_tpu/models/chroma.py: Flux-style rectified
flow over 2x2-packed latents (Flux's packing, ids and mask resize), T5-only
conditioning with its padding as the attention's key mask, guidance 0,
and the modulations from the Approximator. The VAE is Flux's (the port's
FluxPipeline functions). The T5 function returns the tokenizer's mask
beside the embeddings (t5_embed, t5_mask); under `_tiny` the seeded draws
of the JAX hook: min(len(caption) + 1, 8) valid rows of 8, zeros after.

Weights: keymap() maps the single-file (lodestones flow / ComfyUI BFL)
keys: fused img_attn.qkv, txt_attn.qkv and linear1, `.scale` RMS norms,
the distilled_guidance_layer MLP; LoRA under `diffusion_model.`. It drives
load_weights, the adapter export and import (fused pairs: see
keymaps.py) and the full fine-tuning export.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..common import dtype_from_string
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .chroma_model import ChromaConfig, ChromaTransformer
from .flux import (FluxPipeline, latent_image_ids, pack_latents, resize_mask_to_latents,
                   unpack_latents)
from .layers import adapter_kwargs, block_kernel_kwargs, init_module_weights, remat_spec

TINY_T5_LENGTH = 8


@register_model("chroma")
class ChromaPipeline(BasePipeline):
    name = "chroma"

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.chroma_config = self._build_config()
        with torch.device("meta"):
            self.model = ChromaTransformer(self.chroma_config)

    def _build_config(self) -> ChromaConfig:
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype, remat=remat_spec(self.config),
                                      **block_kernel_kwargs(mc))
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        if mc.get("_tiny", False):
            return ChromaConfig.tiny(**kwargs)
        return ChromaConfig(**kwargs)

    def init_params(self, generator: torch.Generator) -> None:
        """Every weight on the pipeline's device, filled as the JAX package
        initialises it."""
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    def _inputs(self, x_packed, t5, t, h, w, t5_mask):
        b = x_packed.shape[0]
        dtype = self.chroma_config.dtype
        return dict(
            hidden_states=x_packed.to(dtype),
            encoder_hidden_states=t5.to(self.device, dtype),
            timestep=t,
            img_ids=latent_image_ids(h // 2, w // 2, device=self.device),
            txt_ids=torch.zeros((t5.shape[1], 3), dtype=torch.float32, device=self.device),
            guidance=torch.zeros((b,), dtype=torch.float32, device=self.device),
            txt_mask=None if t5_mask is None else t5_mask.reshape(b, -1).to(self.device),
            img_seq_len=(h // 2) * (w // 2),
        )

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 16, H, W], t5_embed [B, S, 4096], optional
        t5_mask [B, S] and mask [B, Hm, Wm]. noise and t are drawn from
        `generator` unless given."""
        latents = batch["latents"].to(self.device, torch.float32)
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
        inputs = self._inputs(x_t, batch["t5_embed"], t, h, w, batch.get("t5_mask"))
        return inputs, pack_latents(noise - latents), mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, t5_embed, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, t5_mask=None, noise: Optional[torch.Tensor] = None,
               **_unused):
        """Euler flow sampling through the training forward: latents [B, 16,
        height/8, width/8] f32, model.shift as the sigmas' shift (none by
        default)."""
        from ..training.sampling import euler_flow_sample

        b = t5_embed.shape[0]
        h, w = height // 8, width // 8

        def vel(x, t):
            out = self.forward(self._inputs(pack_latents(x), t5_embed, t, h, w, t5_mask))
            return unpack_latents(out.float(), h, w)

        return euler_flow_sample(vel, (b, 16, h, w), generator, num_steps=num_steps,
                                 guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift"), noise=noise,
                                 device=self.device)

    # --- caching encoders: Flux's VAE, T5 with its mask ----------------------

    def _load_vae(self):
        return FluxPipeline._load_vae(self)

    def get_call_vae_fn(self):
        return FluxPipeline.get_call_vae_fn(self)

    def get_call_text_encoder_fns(self):
        """[T5 fn]: captions -> {"t5_embed": [B, S, 4096] f32, "t5_mask":
        [B, S] int32} CPU tensors; T5 from model.t5_path at
        max_sequence_length (512)."""
        mc = self.model_config
        if mc.get("_tiny", False):
            from ..data.bucketing import seed_from_hash

            dim = self.chroma_config.joint_attention_dim

            def t5_tiny(caps):
                embs = np.zeros((len(caps), TINY_T5_LENGTH, dim), np.float32)
                masks = np.zeros((len(caps), TINY_T5_LENGTH), np.int32)
                for i, c in enumerate(caps):
                    n = min(len(c) + 1, TINY_T5_LENGTH)
                    embs[i, :n] = np.random.default_rng(seed_from_hash(c)).standard_normal((n, dim))
                    masks[i, :n] = 1
                return {"t5_embed": torch.from_numpy(embs), "t5_mask": torch.from_numpy(masks)}

            return [t5_tiny]

        from .text_encoders import HFTextEncoder

        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        t5 = HFTextEncoder("t5", mc["t5_path"], max_length=int(mc.get("max_sequence_length", 512)),
                           tokenizer_path=mc.get("t5_tokenizer_path"), device=self.device,
                           dtype=te_dtype)

        def t5_fn(captions):
            emb, mask = t5.encode(captions, return_mask=True)
            return {"t5_embed": emb, "t5_mask": mask.to(torch.int32)}

        return [t5_fn]

    # --- weights ------------------------------------------------------------

    def _keymap_config(self):
        return self.chroma_config

    def keymap(self):
        """The Chroma single-file keys (BFL dialect) <-> the port's names."""
        from .keymaps import BlockGroup, KeyMap

        cfg = self.chroma_config
        dim, mlp = cfg.hidden_size, cfg.mlp_dim
        top_linears = {
            "x_embedder": "img_in",
            "context_embedder": "txt_in",
            "proj_out": "final_layer.linear",
            "distilled_guidance_layer/in_proj": "distilled_guidance_layer.in_proj",
            "distilled_guidance_layer/out_proj": "distilled_guidance_layer.out_proj",
        }
        top_norms = {}
        for i in range(cfg.approximator_layers):
            top_linears[f"distilled_guidance_layer/layers_{i}_in"] = (
                f"distilled_guidance_layer.layers.{i}.in_layer")
            top_linears[f"distilled_guidance_layer/layers_{i}_out"] = (
                f"distilled_guidance_layer.layers.{i}.out_layer")
            top_norms[f"distilled_guidance_layer/norms_{i}"] = f"distilled_guidance_layer.norms.{i}"
        return KeyMap(
            blocks=[
                BlockGroup(
                    "double_blocks", "double_blocks", "num_layers",
                    linears={"attn_to_out": "img_attn.proj", "attn_to_add_out": "txt_attn.proj",
                             "ff_in": "img_mlp.0", "ff_out": "img_mlp.2",
                             "ff_context_in": "txt_mlp.0", "ff_context_out": "txt_mlp.2"},
                    norms={"attn_to_norm_q": "img_attn.norm.query_norm",
                           "attn_to_norm_k": "img_attn.norm.key_norm",
                           "attn_add_norm_q": "txt_attn.norm.query_norm",
                           "attn_add_norm_k": "txt_attn.norm.key_norm"},
                    fused={"img_attn.qkv": ("attn_to_q", "attn_to_k", "attn_to_v"),
                           "txt_attn.qkv": ("attn_add_q", "attn_add_k", "attn_add_v")},
                    norm_suffix="scale",
                ),
                BlockGroup(
                    "single_blocks", "single_blocks", "num_single_layers",
                    linears={"proj_out": "linear2"},
                    norms={"attn_norm_q": "norm.query_norm", "attn_norm_k": "norm.key_norm"},
                    fused={"linear1": (("attn_to_q", dim), ("attn_to_k", dim),
                                       ("attn_to_v", dim), ("proj_mlp", mlp))},
                    norm_suffix="scale",
                ),
            ],
            top_linears=top_linears,
            top_norms=top_norms,
            top_norm_suffix="scale",
            lora_prefix="diffusion_model.",
        )

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The pretrained transformer (model.ckpt_path, transformer_path,
        single_file_path or diffusers_path) as a state dict of the port's
        names."""
        from .keymaps import keymap_to_state_dict, load_sd_for_pipeline

        return keymap_to_state_dict(load_sd_for_pipeline(self), self.keymap(), self.chroma_config)
