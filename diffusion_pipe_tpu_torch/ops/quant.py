"""Stochastic rounding to bf16: a hand-written CUDA kernel with its plain version.

Counterpart of diffusion_pipe_tpu/ops/quant.py. The TPU kernel `_sr_kernel`
rounds an f32 array to bf16 with the TPU's hardware PRNG; K4
(csrc/stochastic_round.cu) replaces it, fused with the update that it
rounds: a bf16 parameter p becomes SR(f32(p) + f32(u)) in place, for an
update u in bf16 or f32.

The rounding adds 16 random bits to the low half of x's f32 bit pattern and
truncates to bf16, so x rounds away from zero with a probability equal to
its distance from the bf16 value below it over the gap: the rounding is
unbiased. NaN becomes the bf16 NaN 0x7FC0; +-Inf and values exact in bf16
stay as they are. The random bits are a counter-based hash of (seed,
element index) -- murmur3's fmix32 of the index xor a key hashed from the
seed -- so the plain version computes the same bits with int64 tensor ops:
kernel and plain version agree bit for bit, and the CPU path is
deterministic. The TPU's bits cannot be reproduced anywhere; off the TPU
the JAX function rounds to nearest instead.

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises on a dtype, layout or device that
the kernel does not take. The kernel wrapper counts its launches in
`.launches` (read with launch_counts(), zeroed with reset_launch_counts()).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_BF16_NAN = 0x7FC0
UPDATE_DTYPES = (torch.bfloat16, torch.float32)


def _mul32(h, c: int):
    """h * c mod 2^32 for h in [0, 2^32), in pieces that no int64 overflows."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """murmur3's 32-bit finalizer on a Python int or an int64 tensor."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _key(seed: int) -> int:
    return _fmix32((int(seed) + _GOLDEN) & _M32)


# --- plain versions (the CPU path, and what the kernel is checked against) ---


def stochastic_round_plain(x: torch.Tensor, seed: int) -> torch.Tensor:
    """x (f32) stochastically rounded to bf16 with the kernel's bits."""
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic rounding takes f32, got {x.dtype}")
    x = x.contiguous()
    bits = x.view(torch.int32).to(torch.int64) & _M32
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device).reshape(x.shape)
    r = _fmix32(idx ^ _key(seed)) & 0xFFFF
    out = torch.where(torch.isnan(x), _BF16_NAN, ((bits + r) >> 16) & 0xFFFF)
    out = torch.where(out >= 0x8000, out - 0x10000, out)  # as a signed 16-bit pattern
    return out.to(torch.int16).view(torch.bfloat16)


def sr_add_plain(p: torch.Tensor, u: torch.Tensor, seed: int) -> torch.Tensor:
    """SR(f32(p) + f32(u)) as a new bf16 tensor (the plain version of K4)."""
    return stochastic_round_plain(p.float() + u.float(), seed)


# --- kernel wrapper -------------------------------------------------------------


def _entry():
    fn = kernel_build.library("stochastic_round").dpt_sr_add
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_uint32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sr_add_cuda(p: torch.Tensor, u: torch.Tensor, seed: int) -> torch.Tensor:
    """K4: p <- SR(f32(p) + f32(u)) in place on the card; returns p.

    p: contiguous bf16; u: contiguous bf16 or f32 of p's shape, on p's device;
    both 16-byte aligned (the kernel moves 16-byte vectors)."""
    if p.dtype != torch.bfloat16 or u.dtype not in UPDATE_DTYPES:
        raise TypeError(f"K4 takes a bf16 p and a bf16 or f32 u, got {p.dtype}, {u.dtype}")
    if u.shape != p.shape:
        raise ValueError(f"shape mismatch: p {tuple(p.shape)}, u {tuple(u.shape)}")
    if not (p.is_cuda and u.device == p.device):
        raise ValueError("p and u must be on one CUDA device")
    for name, x in (("p", p), ("u", u)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if p.numel() > _M32:
        raise ValueError("K4 hashes 32-bit element indices: at most 2^32 elements")
    fn = _entry()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), u.data_ptr(), p.numel(), int(u.dtype == torch.float32),
                 int(seed) & _M32, stream)
    if err != 0:
        raise RuntimeError(f"dpt_sr_add failed to launch: cudaError {err}")
    sr_add_cuda.launches += 1
    return p


sr_add_cuda.launches = 0
KERNEL_WRAPPERS = (sr_add_cuda,)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def sr_add_(p: torch.Tensor, u: torch.Tensor, seed: int) -> torch.Tensor:
    """p <- SR(f32(p) + f32(u)) in place: K4 on CUDA tensors, the plain
    version on CPU tensors."""
    if p.device.type == "cpu":
        return p.copy_(sr_add_plain(p, u, seed))
    if p.device.type == "cuda":
        return sr_add_cuda(p, u, seed)
    raise ValueError(f"stochastic rounding runs on cuda or cpu tensors, not {p.device}")
