"""Flash attention: hand-written Hopper kernels with their plain versions.

Counterpart of diffusion_pipe_tpu/ops/flash_attention.py. Three CUDA
kernels replace the Pallas TPU kernels `_fwd_kernel`, `_dq_kernel` and
`_dkv_kernel`: K1 in csrc/flash_fwd.cu and K2 in csrc/flash_bwd_dq.cu (head
dim 64, 128 and 256, each at its own tile: FwdTile<256>, DqTile<256>), K3 in
csrc/flash_bwd_dkv.cu (64, 128) and csrc/flash_bwd_dkv_d256.cu (256). Head
dims 96 and 120 (Lumina 2's and OmniGen2's) run the D 128 tiles: the
kernels' tensor maps carry the true D, TMA fills the columns past it with
zeros, and the epilogues store the true D's columns only. Each source file
says what bounds its kernels on the H100 and how they are laid out.

Layout is the model's own [B, S, H, D] for q, k, v, O and the gradients
(the kernels read through strides, so no transpose); the LSE is [B, H, Sq]
float32, natural log. `kv_mask` is [B, Skv], nonzero = valid key. A query
row with no valid key gets O = 0, LSE = DEFAULT_MASK_VALUE and zero
gradients.

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises on a shape or dtype the kernel does
not take. Each kernel wrapper counts its launches in `.launches`.

Under the "attn" remat policy (models/layers.py) each checkpointed block
runs its forward inside `record_forwards(store)`, which appends the O and
LSE of every flash forward to that block's own list, and its recompute in
the backward inside `replay_forwards(store)`, which hands them back in
order instead of launching K1 again (nor counting a launch).
"""

from __future__ import annotations

import contextlib
import ctypes
from collections import deque
from typing import Optional, Tuple

import torch

from . import kernel_build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_DTYPES = (torch.bfloat16, torch.float16)
KERNEL_HEAD_DIMS = (64, 96, 120, 128, 256)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STRIDES = [_L] * 3
_FWD_ARGS = [_P] * 6 + [_I] * 5 + _STRIDES * 3 + [_L, _F, _I, _P]
_DQ_ARGS = [_P] * 8 + [_I] * 5 + _STRIDES * 4 + [_L, _F, _I, _P]
_DKV_ARGS = [_P] * 9 + [_I] * 5 + _STRIDES * 4 + [_L, _F, _I, _P, _I, _P, _P]
_SIGNATURES = {
    "dpt_flash_fwd": ("flash_fwd", _FWD_ARGS),
    "dpt_flash_bwd_dq": ("flash_bwd_dq", _DQ_ARGS),
    "dpt_flash_bwd_dkv": ("flash_bwd_dkv", _DKV_ARGS),
    # K3 at head dim 256, with the same arguments
    "dpt_flash_bwd_dkv_d256": ("flash_bwd_dkv_d256", _DKV_ARGS),
}
# K3's tiles: a block owns 128 keys and steps over 64 queries
# (csrc/flash_bwd_dkv.cu, DkvTile); at head dim 256 it owns 64 keys at the
# full D and steps over 64 queries (csrc/flash_bwd_dkv_d256.cu, Dkv256Tile)
DKV_KEY_TILE, DKV_QUERY_TILE = 128, 64
DKV_KEY_TILE_D256, DKV_QUERY_TILE_D256 = 64, 64
# splits of K3's query loop considered when its key tiles do not fill the card
DKV_MAX_SPLITS = 16


def _symbol(name: str, d: int) -> str:
    """The C entry point of kernel `name` for head dim d (K1 and K2 have
    one entry for every head dim, K3 its own at 256)."""
    return f"{name}_d256" if d == 256 and name == "dpt_flash_bwd_dkv" else name


def _entry(symbol: str):
    lib_name, argtypes = _SIGNATURES[symbol]
    fn = getattr(kernel_build.library(lib_name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(err: int, symbol: str) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: cudaError {err}")


# --- plain versions (the CPU path, and what the kernels are checked against) -


def flash_forward_plain(q, k, v, kv_mask, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """O and LSE in plain PyTorch: f32 softmax, P rounded to v's dtype for PV
    (the math of the JAX package's `_xla_attention`)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        valid = (kv_mask != 0)[:, None, None, :]
        logits = logits.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    empty = torch.isneginf(lse)
    p = torch.exp(logits - lse.masked_fill(empty, 0.0)[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
    return o, lse.masked_fill(empty, DEFAULT_MASK_VALUE)


def _recompute_p_ds(q, k, v, kv_mask, lse, di, do, scale):
    """P and dS (f32, [B, H, Sq, Skv]) recomputed from q, k and the LSE, each
    then rounded to the input dtype as the kernels round them for their
    products."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    if kv_mask is not None:
        p = p.masked_fill(~(kv_mask != 0)[:, None, None, :], 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - di[..., None]) * scale
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_bwd_dq_plain(q, k, v, kv_mask, lse, di, do, scale):
    """dQ = dS K in plain PyTorch (the plain version of K2)."""
    _, ds = _recompute_p_ds(q, k, v, kv_mask, lse, di, do, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, kv_mask, lse, di, do, scale):
    """dK = dS^T Q and dV = P^T dO in plain PyTorch (the plain version of K3)."""
    p, ds = _recompute_p_ds(q, k, v, kv_mask, lse, di, do, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# --- kernel wrappers ----------------------------------------------------------


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """The kernels read 16-byte vectors along D: D contiguous, the other
    strides multiples of 8 elements and a 16-byte aligned base."""
    if (x.stride(-1) == 1 and all(s % 8 == 0 for s in x.stride()[:-1])
            and x.data_ptr() % 16 == 0):
        return x
    return x.contiguous()


def _validate(q, k, v, kv_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernels take bf16 or fp16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take head dim in {KERNEL_HEAD_DIMS}, got {d}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must be on one CUDA device")
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, k.shape[1]):
            raise ValueError(f"kv_mask must be [B, Skv], got {tuple(kv_mask.shape)}")
        if kv_mask.device != q.device:
            raise ValueError("kv_mask must be on q's device")
        kv_mask = kv_mask.to(torch.int32).contiguous()
    return kv_mask


def _mask_args(kv_mask):
    if kv_mask is None:
        return None, 0
    return kv_mask.data_ptr(), kv_mask.stride(0)


def flash_fwd_cuda(q, k, v, kv_mask, scale):
    """K1: O [B, Sq, H, D] and LSE [B, H, Sq] from the forward kernel."""
    kv_mask = _validate(q, k, v, kv_mask)
    q, k, v = (_kernel_layout(x) for x in (q, k, v))
    b, sq, h, d = q.shape
    skv = k.shape[1]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    mask_ptr, mask_sb = _mask_args(kv_mask)
    symbol = _symbol("dpt_flash_fwd", d)
    fn = _entry(symbol)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                 o.data_ptr(), lse.data_ptr(), b, h, sq, skv, d,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 mask_sb, float(scale), int(q.dtype == torch.float16), stream)
    _check(err, symbol)
    flash_fwd_cuda.launches += 1
    return o, lse


def row_dot(do, o):
    """D = rowsum(dO * O) as [B, H, Sq] f32 (plain reduction, as in JAX)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def dkv_splits(key_blocks: int, query_tiles: int, sms: int) -> int:
    """Blocks over which K3 splits each key tile's query loop.

    With at least one key tile (over heads and batch) for every SM there is
    no split. Otherwise it is the count s (up to DKV_MAX_SPLITS and the query
    tiles) with the least waves of key_blocks * s blocks per unit of work,
    ceil(key_blocks * s / sms) / s, the smallest s on a tie: at Wan2.1's
    cross-attention (4 key tiles x 12 heads = 48 blocks, 132 SMs) that is 11,
    528 blocks in 4 full waves."""
    if key_blocks >= sms:
        return 1
    best, best_cost = 1, 1.0
    for s in range(2, min(DKV_MAX_SPLITS, query_tiles) + 1):
        cost = -(-key_blocks * s // sms) / s
        if cost < best_cost - 1e-12:
            best, best_cost = s, cost
    return best


_SM_COUNT = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def dkv_layout(b, h, sq, skv, d, sms):
    """(splits, workspace shape) of K3 on `sms` SMs: the workspace holds the
    f32 partials [key tiles, splits, 2, key tile, D] of its query split
    (None without a split), a key tile being 128 keys, or 64 at D 256."""
    key_tile, query_tile = ((DKV_KEY_TILE_D256, DKV_QUERY_TILE_D256) if d == 256
                            else (DKV_KEY_TILE, DKV_QUERY_TILE))
    key_tiles = b * h * -(-skv // key_tile)
    splits = dkv_splits(key_tiles, -(-sq // query_tile), sms)
    if splits == 1:
        return 1, None
    return splits, (key_tiles, splits, 2, key_tile, d)


def _dkv_workspace(b, h, sq, skv, d, device):
    """(splits, f32 partials, zeroed per-tile counters) for K3's query split
    (dkv_layout; None and None without a split)."""
    splits, shape = dkv_layout(b, h, sq, skv, d, _sm_count(device))
    if shape is None:
        return 1, None, None
    ws = torch.empty(shape, dtype=torch.float32, device=device)
    return splits, ws, torch.zeros(shape[0], dtype=torch.int32, device=device)


def _bwd_cuda(symbol, q, k, v, kv_mask, lse, di, do, scale, n_out, out_len,
              query_split=False):
    """Checks and launches a backward kernel (K2 or K3); returns its n_out
    outputs, each [B, out_len, H, D] in q's dtype, and the split count it
    launched with. query_split: the kernel takes K3's split count, workspace
    and counters as trailing arguments (else the count is 1)."""
    kv_mask = _validate(q, k, v, kv_mask)
    b, sq, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q: {tuple(do.shape)} {do.dtype} {do.device}")
    for name, x in (("lse", lse), ("di", di)):
        if (tuple(x.shape) != (b, h, sq) or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name} must be a contiguous f32 [B, H, Sq] on q's device")
    q, k, v, do = (_kernel_layout(x) for x in (q, k, v, do))
    outs = [torch.empty((b, out_len, h, d), dtype=q.dtype, device=q.device)
            for _ in range(n_out)]
    mask_ptr, mask_sb = _mask_args(kv_mask)
    extra, splits = (), 1
    if query_split:
        splits, ws, counters = _dkv_workspace(b, h, sq, k.shape[1], d, q.device)
        extra = (splits, None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr())
    symbol = _symbol(symbol, d)
    fn = _entry(symbol)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), di.data_ptr(), mask_ptr,
                 *(o.data_ptr() for o in outs), b, h, sq, k.shape[1], d,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 do.stride(0), do.stride(1), do.stride(2),
                 mask_sb, float(scale), int(q.dtype == torch.float16), stream, *extra)
    _check(err, symbol)
    return outs, splits


def flash_bwd_dq_cuda(q, k, v, kv_mask, lse, di, do, scale):
    """K2: dQ [B, Sq, H, D] from the dQ kernel; lse and di are [B, H, Sq] f32."""
    (dq,), _ = _bwd_cuda("dpt_flash_bwd_dq", q, k, v, kv_mask, lse, di, do, scale,
                         1, q.shape[1])
    flash_bwd_dq_cuda.launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, kv_mask, lse, di, do, scale):
    """K3: dK, dV [B, Skv, H, D] from the dK/dV kernel. `.last_splits` is the
    number of blocks the last launch split each key tile's query loop over."""
    (dk, dv), splits = _bwd_cuda("dpt_flash_bwd_dkv", q, k, v, kv_mask, lse, di, do,
                                 scale, 2, k.shape[1], query_split=True)
    flash_bwd_dkv_cuda.launches += 1
    flash_bwd_dkv_cuda.last_splits = splits
    return dk, dv


flash_fwd_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0
flash_bwd_dkv_cuda.last_splits = None
KERNEL_WRAPPERS = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


# --- dispatch -----------------------------------------------------------------


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"flash attention runs on cuda or cpu tensors, not {x.device}")


def flash_forward(q, k, v, kv_mask, scale):
    if _on_cpu(q):
        return flash_forward_plain(q, k, v, kv_mask, scale)
    return flash_fwd_cuda(q, k, v, kv_mask, scale)


def flash_backward(q, k, v, kv_mask, o, lse, do, scale):
    """dQ, dK, dV: D = rowsum(dO * O) as a plain reduction, then K2 and K3
    (or their plain versions for CPU tensors)."""
    di = row_dot(do, o)
    if _on_cpu(q):
        return (flash_bwd_dq_plain(q, k, v, kv_mask, lse, di, do, scale),
                *flash_bwd_dkv_plain(q, k, v, kv_mask, lse, di, do, scale))
    dq = flash_bwd_dq_cuda(q, k, v, kv_mask, lse, di, do, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, kv_mask, lse, di, do, scale)
    return dq, dk, dv


# --- saved forwards of the "attn" policy -------------------------------------

# (mode, store) while a checkpointed block runs under "attn": "record" appends
# each forward's (O, LSE) to the block's store, "replay" takes them back in
# order. A plain global, not a thread-local: the recompute runs on autograd's
# device thread while the thread that called backward() waits.
_forwards: Optional[Tuple[str, deque]] = None


@contextlib.contextmanager
def _forwards_mode(mode: str, store: deque):
    global _forwards
    outer, _forwards = _forwards, (mode, store)
    try:
        yield
    finally:
        _forwards = outer


def record_forwards(store: deque):
    """Within: every flash forward appends its (O, LSE) to `store`."""
    return _forwards_mode("record", store)


def replay_forwards(store: deque):
    """Within: every flash forward returns the next (O, LSE) of `store`,
    recorded by the same call's forward, and launches nothing."""
    return _forwards_mode("replay", store)


def _forward_or_replay(q, k, v, kv_mask, scale):
    if _forwards is None:
        return flash_forward(q, k, v, kv_mask, scale)
    mode, store = _forwards
    if mode == "replay":
        if not store:
            raise RuntimeError("replay of a flash forward that was not recorded")
        return store.popleft()
    o, lse = flash_forward(q, k, v, kv_mask, scale)
    # detached aliases: autograd gives the recompute's outputs their own history
    store.append((o.detach(), lse.detach()))
    return o, lse


class FlashAttention(torch.autograd.Function):
    """Forward returns (O, LSE) from K1 (or, in an "attn" recompute, from
    the block's recorded forward); backward runs the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale):
        o, lse = _forward_or_replay(q, k, v, kv_mask, scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, kv_mask, o, lse, do, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) for q [B, Sq, H, D], k/v [B, Skv, H, D]; differentiable in
    q, k, v. scale defaults to D**-0.5."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, kv_mask, float(scale))
