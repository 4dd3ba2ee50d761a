"""Port flash attention vs the JAX package's Pallas kernel (interpret mode).

On the CPU the port's FlashAttention runs its plain versions: the forward
(O and LSE) and the recompute-formula backward (dQ, dK, dV). They are held
against the JAX `flash_attention`, run as tests/test_flash_attention.py runs
it (DPIPE_PALLAS_INTERPRET=1 from conftest), with the JAX tolerances: 2e-5
on the forward, 5e-4 abs / 1e-3 rel on the grads. All inputs are numpy draws
from a seed, in f32, at B=1, H=2, S=256, D=128, and at D=256 (AuraFlow's
head dim, which the TPU kernels take as any multiple of 128) with and
without a mask over a ragged Skv, and masked at Sq 200 x Skv 130, across
the edges of the D 256 kernels' 128-query and 64-key tiles (the Pallas
kernel's ragged Sq padded with zero queries and cotangents, as
ops/attention.py pads it). At head dims 96 and 120 (Lumina 2's and
OmniGen2's), which the JAX package sends to XLA since its kernel takes
multiples of 128, the plain versions are held against `_xla_attention`,
masked, forward and grads, with the same tolerances.

K3's query split (dkv_splits, dkv_layout) is held on the CPU at 132 SMs,
and each kernel's C entry at each head dim against the libraries that
kernel_build builds and their sources under csrc/.

The kernels themselves are tested on the GPU by test_torch_kernels_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.ops.attention import _xla_attention
from diffusion_pipe_tpu.ops.flash_attention import (
    _flash_attention_fwd_res,
    flash_attention as jax_flash_attention,
)
from diffusion_pipe_tpu_torch.ops import flash_attention as port_fa
from diffusion_pipe_tpu_torch.ops import kernel_build
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE


B, SQ, H, D = 1, 256, 2, 128
BLOCK_Q, BLOCK_K = 256, 128

# case -> (Sq, Skv, masked, head dim)
CASES = {"nomask": (SQ, 256, False, D), "kv_mask": (SQ, 256, True, D),
         "ragged": (SQ, 300, False, D), "d256": (SQ, 256, False, 256),
         "d256_ragged_masked": (SQ, 300, True, 256),
         "d256_ragged_q_masked": (200, 130, True, 256)}


def _inputs(case):
    sq, skv, masked, d = CASES[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, sq, H, d), dtype=np.float32)
    k = rng.standard_normal((B, skv, H, d), dtype=np.float32)
    v = rng.standard_normal((B, skv, H, d), dtype=np.float32)
    do = rng.standard_normal((B, sq, H, d), dtype=np.float32)
    mask = (rng.random((B, skv)) > 0.3).astype(np.int32) if masked else None
    return q, k, v, do, mask


def _jax_fn(sq, skv, mask, d):
    """[B, S, H, D] wrapper around the Pallas kernel: pads a ragged KV length
    (and the mask, with invalid keys) to the block and passes tail_len, and
    pads a ragged Sq with zero queries whose rows it drops, as
    ops/attention.py does."""
    pad = -skv % BLOCK_K
    qpad = -sq % BLOCK_Q
    tail = None if pad == 0 or mask is not None else skv - (skv + pad - BLOCK_K)
    jmask = None if mask is None else jnp.pad(jnp.asarray(mask), ((0, 0), (0, pad)))
    scale = d ** -0.5

    def prep(q, k, v):
        qt, kt, vt = (jnp.swapaxes(x, 1, 2) for x in (q, k, v))
        if pad:
            kt, vt = (jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))) for x in (kt, vt))
        if qpad:
            qt = jnp.pad(qt, ((0, 0), (0, 0), (0, qpad), (0, 0)))
        return qt, kt, vt

    def out(q, k, v):
        o = jax_flash_attention(*prep(q, k, v), jmask, scale, BLOCK_Q, BLOCK_K, tail)
        return jnp.swapaxes(o[:, :, :sq], 1, 2)

    def lse(q, k, v):
        _, res = _flash_attention_fwd_res(*prep(q, k, v), jmask, scale, BLOCK_Q,
                                          BLOCK_K, tail)
        return res[-1][:, :, :sq, 0]

    return out, lse


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The Pallas kernel's O, LSE and (dQ, dK, dV) for `case`, from one jit
    shared by the forward and backward tests."""
    q, k, v, do, mask = _inputs(case)
    out_fn, lse_fn = _jax_fn(q.shape[1], k.shape[1], mask, q.shape[-1])

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(q, k, v, do):
        o, vjp = jax.vjp(out_fn, q, k, v)
        return o, lse_fn(q, k, v), vjp(do)

    return jax.tree.map(np.asarray, run(q, k, v, do))


def _port(q, k, v, mask):
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = port_fa.flash_attention(*t, tmask)
    return t, o, lse


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_pallas(case):
    q, k, v, _, mask = _inputs(case)
    o_ref, lse_ref, _ = _reference(case)
    _, o, lse = _port(q, k, v, mask)
    assert o.shape == q.shape and lse.shape == (B, H, q.shape[1])
    np.testing.assert_allclose(o.detach().numpy(), o_ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_pallas(case):
    q, k, v, do, mask = _inputs(case)
    _, _, refs = _reference(case)
    t, o, _ = _port(q, k, v, mask)
    o.backward(torch.from_numpy(do))
    for got, ref in zip(t, refs):
        assert got.grad.shape == ref.shape
        np.testing.assert_allclose(got.grad.numpy(), ref,
                                   atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("d", [96, 120])
def test_plain_versions_match_xla_attention_at_lumina_head_dims(d):
    """Sq 200 against a masked Skv 130 (every row keeps a valid key, where
    _xla_attention's finite mask value and the port's empty-row rule
    agree): O and dQ, dK, dV against jax.vjp of `_xla_attention`."""
    rng = np.random.default_rng(9)
    q, do = (rng.standard_normal((2, 200, H, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, 130, H, d), dtype=np.float32) for _ in range(2))
    mask = (rng.random((2, 130)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    scale = d ** -0.5

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(q, k, v, do):
        o, vjp = jax.vjp(lambda *x: _xla_attention(*x, jnp.asarray(mask), scale), q, k, v)
        return o, vjp(do)

    o_ref, grads_ref = jax.tree.map(np.asarray, run(q, k, v, do))
    t, o, _ = _port(q, k, v, mask)
    np.testing.assert_allclose(o.detach().numpy(), o_ref, atol=2e-5, rtol=2e-5)
    o.backward(torch.from_numpy(do))
    for got, ref in zip(t, grads_ref):
        np.testing.assert_allclose(got.grad.numpy(), ref, atol=5e-4, rtol=1e-3)


def test_fully_masked_rows_give_zero_output_and_grads():
    """A batch element with no valid key: O = 0, LSE = the mask value and
    zero grads (the kernels' documented semantics)."""
    q, k, v, do, _ = _inputs("nomask")
    mask = np.ones((B, k.shape[1]), np.int32)
    mask[0] = 0
    t, o, lse = _port(q, k, v, mask)
    o.backward(torch.from_numpy(do))
    assert torch.all(o == 0)
    assert torch.all(lse == port_fa.DEFAULT_MASK_VALUE)
    for x in t:
        assert torch.all(x.grad == 0)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers never fall back: a CPU tensor, an f32 tensor or an
    unsupported head dim raises before any build or launch."""
    x = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        port_fa.flash_fwd_cuda(x, x, x, None, 0.1)
    with pytest.raises(TypeError):
        port_fa.flash_fwd_cuda(x.float(), x.float(), x.float(), None, 0.1)
    y = torch.zeros(1, 8, 2, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        port_fa.flash_fwd_cuda(y, y, y, None, 0.1)
    assert port_fa.launch_counts() == {
        "flash_fwd_cuda": 0, "flash_bwd_dq_cuda": 0, "flash_bwd_dkv_cuda": 0}


@pytest.mark.parametrize("key_blocks, query_tiles, want", [
    (48, 336, 11),   # Wan2.1 cross-attention: 4 key tiles x 12 heads -> 528 blocks
    (2016, 336, 1),  # Wan2.1 self-attention: 168 key tiles x 12 heads
    (576, 24, 1),    # Flux-dev: 12 key tiles x 24 heads x 2
    (2, 4, 4),       # fewer query tiles than the best split: one tile a block
    (1656, 69, 1),   # AuraFlow at D 256: 69 key tiles of 64 x 12 heads x 2
    (8, 64, 16),     # D 256, B 2 x H 2 x Skv 128 against Sq 4096: 2 x 2 x 2 key tiles
])
def test_dkv_splits_fill_the_card(key_blocks, query_tiles, want):
    """K3's query split on 132 SMs: none once the key tiles fill the card,
    else the split that wastes least of the last wave."""
    splits = port_fa.dkv_splits(key_blocks, query_tiles, 132)
    assert splits == want
    assert splits <= max(1, min(port_fa.DKV_MAX_SPLITS, query_tiles))


@pytest.mark.parametrize("shape, want", [
    # (B, Sq, Skv, H, D): (splits, workspace shape)
    ((2, 4360, 4360, 12, 256), (1, None)),  # AuraFlow at 1024 px: 1,656 key tiles
    ((2, 4096, 128, 2, 256), (16, (8, 16, 2, 64, 256))),  # short Skv at D 256
    ((1, 21504, 512, 12, 128), (11, (48, 11, 2, 128, 128))),  # Wan2.1 cross-attention
])
def test_dkv_layout(shape, want):
    """K3's split count and workspace on 132 SMs: key tiles of 128 keys,
    or 64 at D 256, over heads and batch, each stepping over 64 queries."""
    b, sq, skv, h, d = shape
    assert (port_fa.DKV_KEY_TILE, port_fa.DKV_QUERY_TILE) == (128, 64)
    assert (port_fa.DKV_KEY_TILE_D256, port_fa.DKV_QUERY_TILE_D256) == (64, 64)
    assert port_fa.dkv_layout(b, h, sq, skv, d, 132) == want


@pytest.mark.parametrize("d", port_fa.KERNEL_HEAD_DIMS)
def test_entries_route_to_built_sources(d):
    """At every head dim each kernel's C entry names a library that
    kernel_build builds from a source present under csrc/: K1 and K2 one
    entry for every head dim (FwdTile<256>, DqTile<256>), K3 its own at 256;
    and every library that _SIGNATURES names is built."""
    want = {"dpt_flash_fwd": "dpt_flash_fwd", "dpt_flash_bwd_dq": "dpt_flash_bwd_dq",
            "dpt_flash_bwd_dkv": "dpt_flash_bwd_dkv_d256" if d == 256 else "dpt_flash_bwd_dkv"}
    for name, symbol in want.items():
        assert port_fa._symbol(name, d) == symbol
        assert port_fa._SIGNATURES[symbol][0] in kernel_build.SOURCES
    for lib, _ in port_fa._SIGNATURES.values():
        assert (kernel_build.CSRC / kernel_build.SOURCES[lib]).is_file()
