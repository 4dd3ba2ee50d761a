"""The W8A8 int8 product and the two hand-written kernels around it.

The JAX package writes its int8 linears (diffusion_pipe_tpu/models/layers.py
int8_dot, int8_dot_bwd8, int8_pq_dot, int8_pq_dot_bwd8) as plain array code
around an int8 dot_general with an int32 result, which XLA fuses. Here the
product is torch._int_mm (cuBLASLt on the card) and the passes around it are
two CUDA kernels (csrc/int8_quant.cu), each with its plain version:

- H1 quant_rows: per-row absmax int8 quantization of [M, K] (bf16 or f32),
  optionally of the input times a per-column f32 vector first;
- H2 rescale_i32: int32 [M, N] -> f32 times a per-row and a per-column f32
  scale (either optional), cast to the output dtype.

Both follow the JAX expressions operand for operand (scale = max|x| / 127
in f32; x8 = clip(round_half_even(x / max(scale, 1e-12)), -127, 127) with a
true division; the rescale (y * row) * col), so the int8 images and the
int32 accumulators equal the JAX package's bit for bit, and each kernel
equals its plain version bit for bit.

torch._int_mm on CUDA takes only more than 16 rows and K, N multiples of 8,
and is fast only when both operands are K-major (its second operand the
transposed view of an [N, K] tensor); int_mm pads short inputs with zero
rows, which quantize to zero and leave the other rows' bits alone.

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises on a dtype, layout or device the
kernel does not take. Each kernel wrapper counts its launches in
`.launches` (launch_counts(), reset_launch_counts()).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernel_build

QUANT_DTYPES = (torch.bfloat16, torch.float32)
# H2's output dtypes -> the kernel's out_kind
RESCALE_OUT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# torch._int_mm on CUDA refuses 16 rows or fewer; shorter inputs are padded
INT_MM_MIN_ROWS = 17
INT_MM_PAD_ROWS = 32


# --- plain versions (the CPU path, and what the kernels are checked against) ---


def quant_rows_plain(x: torch.Tensor, col_scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x8 int8 [M, K], scale f32 [M, 1]) of x [M, K] (times col_scale [K])."""
    xf = x.float()
    if col_scale is not None:
        xf = xf * col_scale.float()
    # a tensor divisor: torch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which can differ from the division by one ulp
    scale = xf.abs().amax(dim=-1, keepdim=True) / xf.new_tensor(127.0)
    q = torch.round(xf / torch.maximum(scale, scale.new_tensor(1e-12)))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def rescale_i32_plain(y: torch.Tensor, row_scale: Optional[torch.Tensor],
                      col_scale: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """(f32(y) * row_scale[M, 1]) * col_scale[N], cast to out_dtype."""
    out = y.float()
    if row_scale is not None:
        out = out * row_scale.reshape(-1, 1)
    if col_scale is not None:
        out = out * col_scale.reshape(1, -1)
    return out.to(out_dtype)


# --- kernel wrappers -------------------------------------------------------------


def _entry(symbol: str, argtypes):
    fn = getattr(kernel_build.library("int8_quant"), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _vector(v: Optional[torch.Tensor], n: int, device, name: str):
    """A contiguous, 16-byte aligned f32 [n] scale on `device` (its
    pointer), or None."""
    if v is None:
        return None, None
    if v.numel() != n or v.dtype != torch.float32 or v.device != device:
        raise ValueError(f"{name} must be {n} f32 values on {device}, got "
                         f"{tuple(v.shape)} {v.dtype} {v.device}")
    v = v.reshape(n).contiguous()
    if v.data_ptr() % 16:
        v = v.clone()
    return v, v.data_ptr()


def _rows(x: torch.Tensor, vec: int) -> torch.Tensor:
    """x as 2-D rows read as 16-byte vectors of `vec` elements: unit column
    stride, row stride and base aligned (a copy otherwise)."""
    if (x.stride(1) == 1 and x.stride(0) % vec == 0
            and x.data_ptr() % 16 == 0):
        return x
    return x.contiguous()


def quant_rows_cuda(x: torch.Tensor, col_scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H1: (x8 int8 [M, K], scale f32 [M, 1]) from x [M, K] bf16 or f32 on
    the card, K a multiple of 8; col_scale: optional f32 [K]."""
    if x.dim() != 2 or x.dtype not in QUANT_DTYPES or not x.is_cuda:
        raise TypeError(f"H1 takes a 2-D bf16 or f32 CUDA tensor, got "
                        f"{tuple(x.shape)} {x.dtype} {x.device}")
    m, k = x.shape
    if k % 8:
        raise ValueError(f"H1 takes rows of a multiple of 8 values, got {k}")
    x = _rows(x, 8)
    col, col_ptr = _vector(col_scale, k, x.device, "col_scale")
    out = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    fn = _entry("dpt_quant_rows", [_P, _I, _L, _P, _P, _P, _I, _I, _P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.float32), x.stride(0), col_ptr,
                 out.data_ptr(), scale.data_ptr(), m, k, stream)
    if err != 0:
        raise RuntimeError(f"dpt_quant_rows failed to launch: cudaError {err}")
    quant_rows_cuda.launches += 1
    return out, scale


def rescale_i32_cuda(y: torch.Tensor, row_scale: Optional[torch.Tensor],
                     col_scale: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """H2: (f32(y) * row_scale) * col_scale as out_dtype, from y [M, N]
    int32 on the card, N a multiple of 4; either scale optional."""
    if y.dim() != 2 or y.dtype != torch.int32 or not y.is_cuda:
        raise TypeError(f"H2 takes a 2-D int32 CUDA tensor, got "
                        f"{tuple(y.shape)} {y.dtype} {y.device}")
    if out_dtype not in RESCALE_OUT:
        raise TypeError(f"H2 writes f32, bf16 or fp16, not {out_dtype}")
    m, n = y.shape
    if n % 4:
        raise ValueError(f"H2 takes rows of a multiple of 4 values, got {n}")
    y = _rows(y, 4)
    row, row_ptr = _vector(row_scale, m, y.device, "row_scale")
    col, col_ptr = _vector(col_scale, n, y.device, "col_scale")
    out = torch.empty((m, n), dtype=out_dtype, device=y.device)
    fn = _entry("dpt_rescale_i32", [_P, _L, _P, _P, _P, _I, _I, _I, _P])
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), y.stride(0), row_ptr, col_ptr, out.data_ptr(),
                 RESCALE_OUT[out_dtype], m, n, stream)
    if err != 0:
        raise RuntimeError(f"dpt_rescale_i32 failed to launch: cudaError {err}")
    rescale_i32_cuda.launches += 1
    return out


quant_rows_cuda.launches = 0
rescale_i32_cuda.launches = 0
KERNEL_WRAPPERS = (quant_rows_cuda, rescale_i32_cuda)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


# --- dispatch -----------------------------------------------------------------------


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"the int8 kernels run on cuda or cpu tensors, not {x.device}")


def quant_rows(x: torch.Tensor, col_scale: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization of x [M, K]: H1 on the card."""
    if _on_cpu(x):
        return quant_rows_plain(x, col_scale)
    return quant_rows_cuda(x, col_scale)


def rescale_i32(y: torch.Tensor, row_scale: Optional[torch.Tensor],
                col_scale: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """int32 [M, N] -> (f32 * row) * col as out_dtype: H2 on the card."""
    if _on_cpu(y):
        return rescale_i32_plain(y, row_scale, col_scale, out_dtype)
    return rescale_i32_cuda(y, row_scale, col_scale, out_dtype)


def int_mm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """a8 [M, K] @ b8 [K, N] as int32 through torch._int_mm, with fewer than
    INT_MM_MIN_ROWS rows padded by zero rows to INT_MM_PAD_ROWS (the
    result's extra rows are dropped). b8 should be the transposed view of a
    contiguous [N, K] tensor: cuBLASLt's int8 product is several times
    slower with a row-major b8."""
    m = a8.shape[0]
    if m >= INT_MM_MIN_ROWS:
        return torch._int_mm(a8, b8)
    return torch._int_mm(F.pad(a8, (0, 0, 0, INT_MM_PAD_ROWS - m)), b8)[:m]
