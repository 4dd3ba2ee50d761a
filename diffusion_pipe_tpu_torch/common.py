"""Shared small utilities: dtype mapping, device choice, media extensions,
timing, math helpers.

PyTorch counterpart of diffusion_pipe_tpu/common.py.
"""

from __future__ import annotations

import contextlib
import functools
import math
import time
from typing import Optional, Union

import torch

# String -> torch dtype (same keys as the JAX package's DTYPE_MAP).
DTYPE_MAP = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "float16": torch.float16,
    "fp16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float8": torch.float8_e4m3fn,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


VIDEO_EXTENSIONS = {
    ".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v", ".wmv", ".flv",
    ".mpg", ".mpeg", ".gif",
}
IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".webp", ".bmp", ".tiff", ".tif"}


def dtype_from_string(name):
    """Map a config dtype string to a torch dtype (passthrough if already one)."""
    if isinstance(name, str):
        return DTYPE_MAP[name]
    return name


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises instead of quietly running on the CPU when CUDA is absent and no
    device was given; pass device="cpu" to run the plain versions on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def round_to_nearest_multiple(x: int, multiple: int) -> int:
    return int(round(x / multiple) * multiple)


def round_down_to_multiple(x: int, multiple: int) -> int:
    return (int(x) // multiple) * multiple


def round_up_to_multiple(x: int, multiple: int) -> int:
    return -(-int(x) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def get_lin_function(x1: float = 256, y1: float = 0.5, x2: float = 4096,
                     y2: float = 1.15):
    """Linear interpolation helper used by the flux resolution-dependent shift."""
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def time_shift(mu: float, sigma: float, t):
    """Flux-style timestep shift."""
    e_mu = math.exp(mu)
    return e_mu / (e_mu + (1 / t - 1) ** sigma)


@contextlib.contextmanager
def log_duration(name: str, enabled: bool = True):
    """Print how long the block took."""
    start = time.time()
    try:
        yield
    finally:
        if enabled:
            print(f"{name}: {time.time() - start:.3f}s")


def first_not_none(*vals):
    for v in vals:
        if v is not None:
            return v
    return None


@functools.lru_cache(maxsize=1024)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return torch.tensor(x, dtype=torch.float64).to(dtype).item()


def weak_scalar(x: float, like: torch.Tensor) -> float:
    """x rounded to like's dtype, as a Python float: how jnp meets a weakly
    typed Python scalar. torch computes a bf16 op with a scalar in f32,
    where the rounded value is exact, so the result is jnp's. (A 0-dim
    tensor made on the card from a host value would wait for the stream.)"""
    return _rounded(float(x), like.dtype)
