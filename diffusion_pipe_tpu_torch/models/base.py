"""Per-model pipeline contract, counterpart of diffusion_pipe_tpu/models/base.py.

A pipeline owns its nn.Module on one device and adapts it to the trainer:

  init_params(generator)                 random init of every weight, in place
  prepare_inputs(batch, generator, ...)  -> (model_inputs, target, mask)
  forward(model_inputs)                  -> model output
  loss_fn(output, target, mask)          -> scalar f32 loss
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..common import resolve_device
from ..training.losses import loss_config_from_model_config, masked_loss


class BasePipeline:
    name: str = "base"

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
