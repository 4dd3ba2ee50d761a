"""Train state and the trainable/frozen split.

Counterpart of diffusion_pipe_tpu/training/train_state.py. The split is
`requires_grad` on the model's parameters, chosen by a predicate on the
parameter name; frozen weights get no gradient buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn


def lora_predicate(name: str, _param=None) -> bool:
    """Trainable iff the parameter is an adapter factor (lora_* / lokr_*)."""
    return any(part.startswith(("lora_", "lokr_")) for part in name.split("."))


def full_ft_predicate(name: str, _param=None) -> bool:
    """Every parameter trainable (full fine-tuning)."""
    return True


def predicate_from_config(config: dict) -> Callable:
    """lora_predicate under an `[adapter]` section, else full fine-tuning.
    A pipeline that trains more than the factors under an adapter says so
    in its trainable_predicate."""
    return lora_predicate if "adapter" in config else full_ft_predicate


def partition_params(model: nn.Module, predicate: Callable) -> Dict[str, nn.Parameter]:
    """Set requires_grad from `predicate(name, param)`; return the trainable
    parameters by name, in module order. An integer parameter (an int8
    weight after prequantization) stays frozen whatever the predicate says:
    it can carry no gradient."""
    trainable = {}
    for name, p in model.named_parameters():
        keep = p.is_floating_point() and bool(predicate(name, p))
        p.requires_grad_(keep)
        if keep:
            trainable[name] = p
    return trainable


@dataclasses.dataclass
class TrainState:
    step: int
    examples: int
    trainable: Dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer
