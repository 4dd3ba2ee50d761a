"""Per-model pipeline contract, counterpart of diffusion_pipe_tpu/models/base.py.

A pipeline owns its nn.Module on one device and adapts it to the trainer:

  init_params(generator)                 random init of every weight, in place
  prepare_inputs(batch, generator, ...)  -> (model_inputs, target, mask)
  forward(model_inputs)                  -> model output
  loss_fn(output, target, mask)          -> scalar f32 loss

and to the training driver (train.py) and the data pipeline:

  load_weights()                 -> state dict of pretrained weights
  get_call_vae_fn()              -> fn(pixels) -> {"latents": ...}
  get_call_text_encoder_fns()    -> [fn(captions) -> {name: embeddings}]
  save_adapter(dir, trainable) / load_adapter(path) -> adapter state dict
  save_model(dir, model)         (full fine-tuning export)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..common import resolve_device
from ..training.losses import loss_config_from_model_config, masked_loss


class BasePipeline:
    name: str = "base"
    framerate: Optional[float] = None  # video families set it
    # True for families whose text encoders run in the step (captions go
    # through the loader)
    pass_captions_to_batch: bool = False

    def __init__(self, config: Dict[str, Any], device: Optional[torch.device] = None):
        self.config = config
        self.model_config = config["model"]
        self.device = resolve_device(device)
        self._loss_kwargs = loss_config_from_model_config(self.model_config)

    def init_params(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise=None, t=None):
        raise NotImplementedError

    def forward(self, model_inputs: Dict[str, Any]):
        raise NotImplementedError

    def loss_fn(self, output, target, mask):
        """Default masked loss in f32."""
        return masked_loss(output, target, mask, **self._loss_kwargs)

    def host_prepare(self, batch):
        """Host-side batch transform before the step (e.g. tokenization)."""
        return batch

    def lr_scale_map(self, base_lr) -> Dict[str, float]:
        """Per-module LR multipliers by parameter-name substring."""
        return {}

    def load_weights(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError(f"{self.name}: loading pretrained weights is not ported yet")

    def get_call_vae_fn(self):
        raise NotImplementedError(f"{self.name}: latent caching is not ported yet")

    def get_call_text_encoder_fns(self):
        raise NotImplementedError(f"{self.name}: text-embedding caching is not ported yet")

    def save_adapter(self, out_dir, trainable) -> None:
        raise NotImplementedError(f"{self.name}: adapter export is not ported yet")

    def load_adapter(self, path) -> Dict[str, torch.Tensor]:
        raise NotImplementedError(f"{self.name}: adapter.init_from_existing is not ported yet")

    def save_model(self, out_dir, model) -> None:
        raise NotImplementedError(
            "saving a fully fine-tuned model in the diffusers layout (models/keymaps.py) "
            "is not ported yet (ROADMAP A4)")
