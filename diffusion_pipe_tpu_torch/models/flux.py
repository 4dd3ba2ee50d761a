"""Flux pipeline: training-input preparation around FluxTransformer.

Counterpart of diffusion_pipe_tpu/models/flux.py (prepare_inputs, forward,
random init). Rectified-flow noising with logit-normal t, 2x2 latent
patchify, 3-axis image position ids, the guidance vector from config. The
noise and t come from a torch.Generator, or are passed in as tensors (the
tests feed the JAX package's draws). Loading pretrained weights, adapter
export, sampling and the caching encoders are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..common import dtype_from_string
from . import register_model
from .base import BasePipeline
from .flux_model import FluxConfig, FluxTransformer
from .layers import block_kernel_kwargs, init_module_weights, remat_spec
from ..training.flow import TimestepDistribution, sample_timesteps


def pack_latents(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/2)(W/2), C*4] (flux 2x2 patchify)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


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


@register_model("flux", "flex", "flux-kontext")
class FluxPipeline(BasePipeline):
    name = "flux"

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        mc = self.model_config
        if mc.get("bypass_guidance_embedding"):
            raise NotImplementedError("model.bypass_guidance_embedding is not ported yet")
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(mc)
        self.flux_config = self._build_flux_config()
        # parameters are allocated by init_params, on the pipeline's device
        with torch.device("meta"):
            self.model = FluxTransformer(self.flux_config)

    def _build_flux_config(self) -> FluxConfig:
        mc = self.model_config
        adapter = self.config.get("adapter", {})
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(
            dtype=dtype,
            param_dtype=dtype,
            guidance_embeds=bool(mc.get("guidance_embeds", True)),
            remat=remat_spec(self.config),
            **block_kernel_kwargs(mc),
        )
        if adapter.get("type") == "lora":
            kwargs.update(
                lora_rank=int(adapter["rank"]),
                lora_alpha=float(adapter["alpha"]),
                lora_dropout=float(adapter.get("dropout", 0.0)),
                lora_dtype=dtype_from_string(adapter.get("dtype", mc.get("dtype", "bfloat16"))),
            )
        elif adapter:
            raise NotImplementedError(f"adapter type {adapter.get('type')!r} is not ported yet")
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
            guidance=guidance if self.flux_config.guidance_embeds else None,
            txt_mask=None if txt_mask is None else txt_mask.to(self.device),
            img_seq_len=image_seq_len,
        )
        return model_inputs, target, mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)
