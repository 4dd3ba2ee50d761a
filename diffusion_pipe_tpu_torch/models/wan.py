"""Wan pipeline: training-input preparation around WanTransformer.

Counterpart of diffusion_pipe_tpu/models/wan.py, t2v only (prepare_inputs,
forward, random init): flow matching on 5-D video latents with logit-normal
t (image_seq_len = (h/2)(w/2)), the text embeddings zero-padded to text_len
and zeroed past each sample's seq_len, an optional loss mask resized to the
latent grid, and t scaled to [0, 1000] for the model. The noise and t come
from a torch.Generator, or are passed in as tensors (the tests feed the JAX
package's draws). Not ported: i2v/flf2v/ti2v, the VAE, UMT5 and CLIP
encoders and the uncached-text path, pretrained weights, export, block swap,
sequence sharding and the pipeline-parallel program.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..common import dtype_from_string
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .flux import resize_mask_to_latents
from .layers import block_kernel_kwargs, init_module_weights, remat_spec
from .wan_model import WanConfig, WanTransformer

WAN_VARIANTS = {"t2v-1.3b": WanConfig.t2v_1_3b, "t2v-14b": WanConfig.t2v_14b}

# config keys of the JAX pipeline that select paths not ported yet
_NOT_PORTED_TOP = ("blocks_to_swap", "stream_prefetch", "sequence_sharding",
                   "swap_activation_checkpointing")
_NOT_PORTED_MODEL = ("ckpt_path", "skyreels")


@register_model("wan", "wan21", "wan22")
class WanPipeline(BasePipeline):
    name = "wan"

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        mc = self.model_config
        for key in _NOT_PORTED_TOP:
            if config.get(key):
                raise NotImplementedError(f"{key} is not ported yet")
        for key in _NOT_PORTED_MODEL:
            if mc.get(key):
                raise NotImplementedError(f"model.{key} is not ported yet")
        if not mc.get("cache_text_embeddings", True):
            raise NotImplementedError("uncached text embeddings (UMT5 in the step) "
                                      "are not ported yet")
        self.tdist = TimestepDistribution.from_model_config(mc)
        self.wan_config = self._build_wan_config()
        # parameters are allocated by init_params, on the pipeline's device
        with torch.device("meta"):
            self.model = WanTransformer(self.wan_config)

    def _build_wan_config(self) -> WanConfig:
        mc = self.model_config
        adapter = self.config.get("adapter", {})
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype,
                                      remat=remat_spec(self.config),
                                      **block_kernel_kwargs(mc))
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
            vt = mc.get("variant_type", "t2v")
            if vt != "t2v":
                raise NotImplementedError(f"wan variant_type {vt!r} is not ported yet")
            return WanConfig.tiny(**kwargs)
        variant = mc.get("variant", "t2v-1.3b")
        if variant not in WAN_VARIANTS:
            raise NotImplementedError(f"wan variant {variant!r} is not ported yet")
        if mc.get("num_layers"):  # depth override
            kwargs["num_layers"] = int(mc["num_layers"])
        return WAN_VARIANTS[variant](**kwargs)

    def init_params(self, generator: torch.Generator) -> None:
        """Allocate every weight on the pipeline's device and fill it as the
        JAX package initialises it: lecun-normal kernels (the patch
        embedding's over its C*kt*kh*kw fan-in), zero biases, modulation
        tables normal / sqrt(dim), norm scales one, LoRA A uniform (stored
        unshifted) and B zero."""
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None,
                       t: Optional[torch.Tensor] = None):
        """batch: latents [B,16,F,H,W], text_embeddings [B,<=text_len,4096],
        optional seq_lens [B] (or [B,1]) and mask [B,Hm,Wm]. noise
        [B,16,F,H,W] and t [B] are drawn from `generator` unless given."""
        cfg = self.wan_config
        latents = batch["latents"].to(self.device, torch.float32)
        b, _, _, h, w = latents.shape

        mask = batch.get("mask")
        if mask is not None:  # [B, 1, 1, h, w], broadcast over C and F
            mask = resize_mask_to_latents(mask.to(self.device), h, w, 1)[:, :, None]

        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator,
                                 quantile=timestep_quantile,
                                 image_seq_len=(h // 2) * (w // 2), device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                dtype=torch.float32, device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1, 1)
        x_t = (1.0 - t_exp) * latents + t_exp * noise
        target = noise - latents

        ctx = batch["text_embeddings"].to(self.device, torch.float32)
        pad = cfg.text_len - ctx.shape[1]
        if pad > 0:
            ctx = torch.nn.functional.pad(ctx, (0, 0, 0, pad))
        if "seq_lens" in batch:
            sl = batch["seq_lens"].to(self.device).reshape(-1)
            idx = torch.arange(cfg.text_len, device=self.device)[None, :]
            ctx = torch.where((idx < sl[:, None])[..., None], ctx, 0.0)

        model_inputs = dict(x=x_t.to(cfg.dtype), t=t * 1000.0, context=ctx)
        return model_inputs, target, mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)
