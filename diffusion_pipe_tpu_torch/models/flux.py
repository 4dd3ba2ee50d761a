"""Flux pipeline: training-input preparation around FluxTransformer, and
what the training driver needs of it.

Counterpart of diffusion_pipe_tpu/models/flux.py: rectified-flow noising
with logit-normal t, 2x2 latent patchify, 3-axis image position ids, the
guidance vector from config (prepare_inputs, forward, random init); the
diffusers/BFL weight loading, the VAE and text-encoder functions of the
caching phase (each builds its model at its first call), and the
diffusers-lora adapter export and import, and the keymap whose inverse
writes a fully fine-tuned model in the diffusers layout. The noise and t come from a
torch.Generator, or are passed in as tensors (the tests feed the JAX
package's draws). `sample` is the Euler flow sampler of `--test_sample`
through the training forward.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..common import dtype_from_string
from . import register_model
from .base import BasePipeline
from .flux_model import FluxConfig, FluxTransformer
from .layers import adapter_kwargs, block_kernel_kwargs, init_module_weights, remat_spec
from ..training.flow import TimestepDistribution, sample_timesteps


def pack_latents(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/2)(W/2), C*4] (flux 2x2 patchify)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, (h/2)(w/2), C*4] -> [B, C, h, w], the inverse of pack_latents."""
    b, _, c4 = x.shape
    x = x.reshape(b, h // 2, w // 2, c4 // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c4 // 4, h, w)


def latent_image_ids(h_half: int, w_half: int, modality: int = 0,
                     device=None) -> torch.Tensor:
    """[h/2 * w/2, 3] f32 ids: (modality, row, col)."""
    row = torch.arange(h_half, device=device).repeat_interleave(w_half)
    col = torch.arange(w_half, device=device).repeat(h_half)
    mod = torch.full_like(row, modality)
    return torch.stack([mod, row, col], dim=-1).float()


def resize_mask_to_latents(mask: torch.Tensor, h: int, w: int, c: int) -> torch.Tensor:
    """mask [B, Hm, Wm] -> [B, c, h, w] by nearest resize, channels expanded."""
    m = torch.nn.functional.interpolate(mask.float()[:, None], size=(h, w),
                                        mode="nearest-exact")
    return m.expand(-1, c, -1, -1)


def seeded_text_encoder_fns(t5_len: int, t5_dim: int, clip_dim: int):
    """Stand-in T5 and CLIP functions: each caption's embeddings are normal
    draws of numpy's generator seeded from the caption's hash (the JAX
    package's `_tiny` hook, the same values at the same sizes)."""
    from .text_encoders import seeded_draws

    def t5_fn(captions):
        return {"t5_embed": seeded_draws(captions, "", (t5_len, t5_dim))}

    def clip_fn(captions):
        return {"clip_embed": seeded_draws(captions, "", (clip_dim,))}

    return [t5_fn, clip_fn]


FLUX_LAYOUT_KEYS = ("num_layers", "num_single_layers")


@register_model("flux", "flex", "flux-kontext")
class FluxPipeline(BasePipeline):
    name = "flux"

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        mc = self.model_config
        # FLEX trains with the guidance embedder silenced, its weights kept
        self._bypass_guidance = bool(mc.get("bypass_guidance_embedding", False))
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(mc)
        self.flux_config = self._build_flux_config()
        # parameters are allocated by init_params, on the pipeline's device
        with torch.device("meta"):
            self.model = FluxTransformer(self.flux_config)

    def _build_flux_config(self, layout: Optional[Dict[str, int]] = None) -> FluxConfig:
        """Flux-dev's layout (19 double, 38 single blocks), or the block
        counts of [model] (num_layers, num_single_layers), or `layout`
        (what load_weights read from the checkpoint: Flex and Kontext
        variants have other counts)."""
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(
            dtype=dtype,
            param_dtype=dtype,
            guidance_embeds=bool(mc.get("guidance_embeds", True)),
            remat=remat_spec(self.config),
            **block_kernel_kwargs(mc),
        )
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        kwargs.update({k: int(mc[k]) for k in FLUX_LAYOUT_KEYS if mc.get(k) is not None})
        kwargs.update(layout or {})
        if mc.get("_tiny", False):  # test hook
            return FluxConfig.tiny(**kwargs)
        return FluxConfig(**kwargs)

    def init_params(self, generator: torch.Generator) -> None:
        """Allocate every weight on the pipeline's device and fill it as the
        JAX package initialises it: lecun-normal kernels, zero biases, LoRA A
        uniform (stored unshifted) and B zero, RMSNorm scale one."""
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None,
                       t: Optional[torch.Tensor] = None):
        """batch: latents [B,16,H,W], t5_embed [B,S,4096], clip_embed [B,768],
        optional mask [B,Hm,Wm], control_latents [B,16,H,W], t5_mask [B,S].
        noise [B,16,H,W] and t [B] are drawn from `generator` unless given."""
        latents = batch["latents"].to(self.device, torch.float32)
        b, c, h, w = latents.shape
        image_seq_len = (h // 2) * (w // 2)

        mask = batch.get("mask")
        if mask is not None:
            mask = pack_latents(resize_mask_to_latents(mask.to(self.device), h, w, c))

        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator,
                                 quantile=timestep_quantile,
                                 image_seq_len=image_seq_len, device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                dtype=torch.float32, device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1)
        x_t = pack_latents((1.0 - t_exp) * latents + t_exp * noise)
        target = pack_latents(noise - latents)

        img_ids = latent_image_ids(h // 2, w // 2, device=self.device)
        t5 = batch["t5_embed"].to(self.device)
        txt_ids = torch.zeros((t5.shape[1], 3), dtype=torch.float32, device=self.device)
        guidance = torch.full((b,), float(self.model_config.get("guidance", 1.0)),
                              dtype=torch.float32, device=self.device)

        control = batch.get("control_latents")
        if control is not None:
            control_ids = latent_image_ids(h // 2, w // 2, modality=1, device=self.device)
            img_ids = torch.cat([img_ids, control_ids], dim=0)
            x_t = torch.cat([x_t, pack_latents(control.to(self.device, torch.float32))], dim=1)

        dtype = self.flux_config.dtype
        txt_mask = batch.get("t5_mask")
        model_inputs = dict(
            hidden_states=x_t.to(dtype),
            encoder_hidden_states=t5.to(dtype),
            pooled_projections=batch["clip_embed"].to(self.device, dtype),
            timestep=t,
            img_ids=img_ids,
            txt_ids=txt_ids,
            guidance=self._guidance(guidance),
            txt_mask=None if txt_mask is None else txt_mask.to(self.device),
            img_seq_len=image_seq_len,
        )
        return model_inputs, target, mask

    def _guidance(self, guidance):
        """The guidance vector, or None without a guidance embedder or
        under model.bypass_guidance_embedding."""
        if self.flux_config.guidance_embeds and not self._bypass_guidance:
            return guidance
        return None

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, t5_embed, clip_embed, width: int, height: int, generator=None,
               num_steps: int = 20, guidance_scale: float = 1.0, uncond_embeds=None,
               noise: Optional[torch.Tensor] = None, **_unused):
        """Euler flow sampling through the training forward: latents [B, 16,
        height/8, width/8] f32 from `noise` or the generator's N(0, 1),
        model.shift as the sigmas' shift (none by default), the config's
        guidance vector; uncond_embeds ({t5_embed, clip_embed}) with
        guidance_scale for classifier-free guidance."""
        from ..training.sampling import euler_flow_sample

        dtype = self.flux_config.dtype
        b = t5_embed.shape[0]
        h, w = height // 8, width // 8
        img_ids = latent_image_ids(h // 2, w // 2, device=self.device)
        txt_ids = torch.zeros((t5_embed.shape[1], 3), dtype=torch.float32, device=self.device)
        guidance = self._guidance(torch.full((b,), float(self.model_config.get("guidance", 1.0)),
                                             dtype=torch.float32, device=self.device))

        def vel(embeds, pooled):
            embeds = embeds.to(self.device, dtype)
            pooled = pooled.to(self.device, dtype)

            def fn(x, t):
                out = self.forward(dict(
                    hidden_states=pack_latents(x).to(dtype), encoder_hidden_states=embeds,
                    pooled_projections=pooled, timestep=t, img_ids=img_ids, txt_ids=txt_ids,
                    guidance=guidance, txt_mask=None, img_seq_len=(h // 2) * (w // 2)))
                return unpack_latents(out.float(), h, w)

            return fn

        uncond = None
        if uncond_embeds is not None:
            uncond = vel(uncond_embeds["t5_embed"], uncond_embeds["clip_embed"])
        return euler_flow_sample(vel(t5_embed, clip_embed), (b, 16, h, w), generator,
                                 num_steps=num_steps, guidance_scale=guidance_scale,
                                 uncond_velocity_fn=uncond, shift=self.model_config.get("shift"),
                                 noise=noise, device=self.device)

    # --- weight-key map -----------------------------------------------------

    def _keymap_config(self):
        return self.flux_config

    def keymap(self):
        """diffusers FluxTransformer2DModel keys as a KeyMap: it drives the
        full fine-tuning export (BasePipeline.save_model, the diffusers
        layout). The adapters keep the diffusers-lora functions below."""
        from .flux_convert import (_DOUBLE_MAP, _DOUBLE_NORMS, _GUIDANCE, _SINGLE_MAP,
                                   _SINGLE_NORMS, _TOP)
        from .keymaps import BlockGroup, KeyMap

        top = dict(_TOP, **(_GUIDANCE if self.flux_config.guidance_embeds else {}))
        return KeyMap(
            blocks=[BlockGroup("double_blocks", "transformer_blocks", "num_layers",
                               linears=dict(_DOUBLE_MAP), norms=dict(_DOUBLE_NORMS)),
                    BlockGroup("single_blocks", "single_transformer_blocks", "num_single_layers",
                               linears=dict(_SINGLE_MAP), norms=dict(_SINGLE_NORMS))],
            top_linears=top,
            lora_prefix="transformer.",
        )

    # --- pretrained weights -------------------------------------------------

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The pretrained transformer as a state dict of the port's names:
        model.transformer_path (a safetensors file or folder), else
        model.diffusers_path/transformer; diffusers or BFL keys, with
        model.merge_adapters fused in first. The model is rebuilt on the
        checkpoint's block counts (checked against [model]'s); a key
        missing or left over raises KeyError naming it."""
        from .flux_convert import convert_bfl_flux, convert_diffusers_flux
        from .keymaps import count_blocks, layout_override
        from .weights import load_safetensors_dir, merge_adapters_into_state_dict

        mc = self.model_config
        path = mc.get("transformer_path")
        if path is None:
            path = str(Path(mc["diffusers_path"]) / "transformer")
        sd = merge_adapters_into_state_dict(load_safetensors_dir(path),
                                            mc.get("merge_adapters", []))
        bfl = any(k.startswith("double_blocks.") for k in sd)
        prefixes = ("double_blocks", "single_blocks") if bfl else (
            "transformer_blocks", "single_transformer_blocks")
        layout = layout_override(mc, {k: count_blocks(sd, p)
                                      for k, p in zip(FLUX_LAYOUT_KEYS, prefixes)})
        if any(getattr(self.flux_config, k) != v for k, v in layout.items()):
            self.flux_config = self._build_flux_config(layout)
            with torch.device("meta"):
                self.model = FluxTransformer(self.flux_config)
        if bfl:
            return convert_bfl_flux(sd, self.flux_config)
        return convert_diffusers_flux(sd, self.flux_config)

    # --- caching encoders ---------------------------------------------------

    def _load_vae(self):
        """The VAE on the pipeline's device in the model dtype: random at a
        small width under the `_tiny` test hook, else from model.vae_path
        (or diffusers_path/vae) in the diffusers layout."""
        if getattr(self, "_vae", None) is None:
            from .autoencoder_kl import AutoencoderKL, VAEConfig, convert_diffusers_vae
            from .weights import load_safetensors_dir

            mc = self.model_config
            dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
            if mc.get("_tiny", False):
                cfg = VAEConfig(latent_channels=16, block_out_channels=(8, 8, 16, 16),
                                norm_num_groups=4, layers_per_block=1,
                                scaling_factor=1.0, shift_factor=0.0, dtype=dtype)
                vae = AutoencoderKL(cfg).to(self.device)
                vae.init_weights(torch.Generator(device=self.device).manual_seed(0))
            else:
                cfg = VAEConfig.flux(dtype=dtype)
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
        {"latents": [B, 16, H/8, W/8] f32 CPU tensor}; the VAE loads at the
        first call."""

        def fn(pixels):
            vae = self._load_vae()
            x = torch.from_numpy(np.asarray(pixels, np.float32))
            if x.dim() == 5:  # (B, C, F=1, H, W) -> image
                x = x[:, :, 0]
            with torch.no_grad():
                z = vae.encode(x.to(self.device))
            return {"latents": z.float().cpu()}

        return fn

    def get_call_text_encoder_fns(self):
        """[T5 fn, CLIP fn], each captions -> {name: f32 CPU tensor}. Under
        the `_tiny` hook, seeded draws at the tiny widths (16 T5 tokens);
        otherwise transformers' T5 and CLIP from model.t5_path / clip_path
        (or the diffusers folder), loaded at their first call."""
        from .text_encoders import HFTextEncoder

        mc = self.model_config
        cfg = self.flux_config
        if mc.get("_tiny", False):
            return seeded_text_encoder_fns(16, cfg.joint_attention_dim,
                                           cfg.pooled_projection_dim)
        base = mc.get("diffusers_path")
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        t5 = HFTextEncoder(
            "t5", mc.get("t5_path", str(Path(base or "") / "text_encoder_2")),
            max_length=int(mc.get("max_sequence_length", 512)),
            tokenizer_path=mc.get("t5_tokenizer_path",
                                  str(Path(base) / "tokenizer_2") if base else None),
            device=self.device, dtype=te_dtype)
        clip = HFTextEncoder(
            "clip_pooled", mc.get("clip_path", str(Path(base or "") / "text_encoder")),
            max_length=77,
            tokenizer_path=mc.get("clip_tokenizer_path",
                                  str(Path(base) / "tokenizer") if base else None),
            device=self.device, dtype=te_dtype)

        def t5_fn(captions):
            return {"t5_embed": t5.encode(captions)}

        def clip_fn(captions):
            return {"clip_embed": clip.encode(captions)}

        return [t5_fn, clip_fn]

    # --- adapters -----------------------------------------------------------

    def save_adapter(self, out_dir, trainable) -> None:
        """The trainable LoRA factors as diffusers-lora safetensors
        (adapter_model.safetensors), keys and bits as the JAX export."""
        from .. import safetensors_io
        from .flux_convert import export_lora_diffusers

        sd = export_lora_diffusers(trainable, self.flux_config)
        safetensors_io.save_file(sd, str(Path(out_dir) / "adapter_model.safetensors"))

    def load_adapter(self, path) -> Dict[str, torch.Tensor]:
        """adapter.init_from_existing: the LoRA factors of the one
        safetensors file in `path` (exported by either package), as a
        partial state dict to load over the initialised model."""
        from .. import safetensors_io
        from .flux_convert import import_lora_diffusers

        files = sorted(Path(path).glob("*.safetensors"))
        if len(files) != 1:
            raise RuntimeError(f"init_from_existing: expected exactly one safetensors file "
                               f"in {path}, found {len(files)}")
        return import_lora_diffusers(safetensors_io.load_file(files[0]), self.flux_config)
