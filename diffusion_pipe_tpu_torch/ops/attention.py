"""Attention entry point: [B, S, H, D] scaled dot-product attention.

Counterpart of diffusion_pipe_tpu/ops/attention.py. Every call goes to the
flash-attention path (ops/flash_attention.py): the hand-written kernels for
CUDA tensors, their plain versions for CPU tensors. The TPU dispatcher's
block picking, padding to block multiples and size heuristic have no
counterpart: the kernels bound ragged lengths themselves.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled dot-product attention.

    q: [B, Sq, H, D]; k, v: [B, Skv, H, D]; kv_mask: optional [B, Skv],
    nonzero = valid key. scale defaults to D**-0.5.
    """
    return flash_attention(q, k, v, kv_mask, scale)[0]
