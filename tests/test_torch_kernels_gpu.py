"""The port's CUDA kernels against their plain versions.

Needs an NVIDIA GPU with nvcc (the kernels build at first use) and skips
without one. It imports neither JAX nor the JAX package, so it also runs on
a machine without them:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Flash attention (K1-K3): bf16 and fp16 inputs at B=1, H=2, Sq=256, D=128,
64, 256, 96 and 120 (D 96 and 120, Lumina 2's and OmniGen2's, on the D 128
tiles with TMA's zero fill past D) (and a ragged Skv=300, a cross-attention Skv=40 shorter than one key
tile, a key mask, a ragged Sq=200 that is no multiple of K1's and K2's
128-row query tile, heads 2-3 of six as a strided view, Sq=4096 against
Skv=128, where K3 splits its query loop over blocks, Sq=328 against Skv=50,
a masked Skv=1000 of 16 key steps against Sq=130, Wan i2v's image
cross-attention, Skv=257 and 514 (flf2v), against Sq=1024, Skv=63, 64
and 65, the edges of the 64-key tiles at D 256, and Skv=31, 33, 47 and
49, the edges of K2's first validity word and of its 48-key step at D
256): each kernel's error
against the f32 plain result must be at most twice the plain version's in
the same dtype, plus 1e-3 of the reference's largest magnitude. K3 gives the
same bits on two launches, with and without the query split, at D 128 and
256, and K2 at the Flux-dev and Wan2.1 cross-attention shapes and at
AuraFlow's (D 256); K2 and K3 at the i2v image
cross-attention (H 40, Skv 257 and 514). SDXL's cross-attention (B 4,
H 20, Sq 256 against 77 CLIP tokens, D 64), with and without a padded
batch element, K2 and K3 deterministic there. SD3's joint sequence at
1024 px (4,429 keys, D 64, a ragged last tile) and Chroma's at 512 px (1,536
keys, D 128, 77 and 300 of the 512 T5 keys valid), at 4 heads, K2 and K3
deterministic there. AuraFlow's joint sequence at 1024 px (B 2, 4,360 keys, D 256, a
ragged last tile; 4 of its 12 heads), with and without a key mask, K2 and K3
deterministic there. A batch element whose keys are
all masked gets O = 0, the mask value as its LSE and zero gradients, with
and without the query split, at D 64, 96, 120, 128 and 256. At D 96 and
120 the inputs are also column slices of wider buffers whose spare columns
hold NaN (no column past D is read) and the outputs are checked whole (no
column past D is written over the next head's); Lumina 2's and OmniGen2's
joint sequences (4,352 keys, 60 / 200 of 256 caption keys valid; the noise
refiner's 4,096 unmasked) at 3 heads; HiDream-I1's (B 1, 4,480 rows, 20
heads of 128, unmasked, bf16 and fp16), K2 and K3 deterministic there;
the Hunyuan families' (HunyuanVideo's 9,472-row joint sequence and 256-row
refiner, HunyuanImage-2.1's 5,190-row joint sequence with masked keys in
its middle and 966-row refiner; 4 heads, bf16 and fp16), the padded keys
without dK / dV, K2 and K3 deterministic; an unsupported head dim (32, 80,
112) raises.

Stochastic rounding (K4): bit for bit equal to its plain version, with bf16
and f32 updates, at a ragged size and with NaN, +-Inf and exact values.

The quantization and rescale around the int8 product (H1, H2): bit for bit
equal to their plain versions (bf16 and f32 inputs, with and without H1's
column pre-scale, 2 / 17 / 2048 rows, row-strided views); torch._int_mm
through the zero-row padding below 17 rows; int8_pq_dot_bwd8 on the card
against the plain path on the CPU.

The Wan caching encoders on the card: the Wan 2.1 VAE (encode and decode of
a 1 + 4 + 4-frame clip) and UMT5 (with padding), at tiny width in f32,
against the same weights on the CPU.

The offload checkpointing policies ("offload_attn", "unsloth") with their
host copies delayed on the side stream: true's loss and gradients, bit for
bit, with dropout. The Euler sampler under "attn": K1 once a block a step,
no K2 or K3.
"""

import contextlib

import numpy as np
import pytest
import torch

from diffusion_pipe_tpu_torch.ops import flash_attention as port_fa
from diffusion_pipe_tpu_torch.ops import int8_quant, quant

B, H = 1, 2
# name: (Sq, Skv, masked, heads of a wider tensor taken as a strided view)
CASES = {"nomask": (256, 256, False, None), "kv_mask": (256, 256, True, None),
         "ragged": (256, 300, False, None), "cross": (256, 40, False, None),
         "ragged_q": (200, 300, False, None), "head_view": (256, 256, False, slice(2, 4)),
         "long_q_short_kv": (4096, 128, False, None),
         # K2's tile edges (128 query rows a block, 64 keys a step, 3 stages):
         # Sq no multiple of 128 against Skv shorter than one key step, and
         # Skv no multiple of it, masked, over enough steps to refill the ring
         "short_kv_ragged_q": (328, 50, False, None),
         "ragged_steps_masked": (130, 1000, True, None),
         # Wan i2v's image cross-attention over 257 CLIP tokens (flf2v: 514):
         # one key past the last full tile
         "clip_cross": (1024, 257, False, None), "flf2v_cross": (1024, 514, False, None),
         # the edges of K1's 64-key step and K3's 64-key tile at D 256, against
         # Sq no multiple of 128: one key short of a tile (masked), a whole
         # tile, one key past it (on a head view)
         "kv63_masked": (200, 63, True, None), "kv64": (130, 64, False, None),
         "kv65_head_view": (328, 65, False, slice(2, 4)),
         # the edges of K2's first 32-key validity word and of its 48-key
         # step at D 256 (2 stages), against Sq no multiple of 128: one key
         # short of each (masked), one key past each (on a head view)
         "kv31_masked": (200, 31, True, None), "kv33_head_view": (328, 33, False, slice(2, 4)),
         "kv47_masked": (200, 47, True, None), "kv49_head_view": (328, 49, False, slice(2, 4))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(case, dev, dtype=torch.bfloat16, d=128):
    sq, skv, masked, heads = CASES[case]
    h = H if heads is None else 6
    rng = np.random.default_rng(7)
    q, do = (rng.standard_normal((B, sq, h, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, skv, h, d), dtype=np.float32) for _ in range(2))
    mask = (rng.random((B, skv)) > 0.3).astype(np.int32) if masked else None
    q, k, v, do = (torch.from_numpy(x).to(dev, dtype) for x in (q, k, v, do))
    if heads is not None:
        q, k, v, do = (x[:, :, heads] for x in (q, k, v, do))
    return q, k, v, do, (None if mask is None else torch.from_numpy(mask).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64, 256, 96, 120])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_on_gpu(case, dtype, d, cuda_device):
    q, k, v, do, mask = _inputs(case, cuda_device, dtype, d)
    scale = d ** -0.5

    def plain(q, k, v, do):
        o, lse = port_fa.flash_forward_plain(q, k, v, mask, scale)
        di = port_fa.row_dot(do, o)
        return (o, lse, port_fa.flash_bwd_dq_plain(q, k, v, mask, lse, di, do, scale),
                *port_fa.flash_bwd_dkv_plain(q, k, v, mask, lse, di, do, scale))

    refs = plain(q.float(), k.float(), v.float(), do.float())
    plains = plain(q, k, v, do)
    o, lse = port_fa.flash_fwd_cuda(q, k, v, mask, scale)
    di = port_fa.row_dot(do, o)
    dq = port_fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale)
    dk, dv = port_fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)
    torch.cuda.synchronize()
    if case == "long_q_short_kv":
        assert port_fa.flash_bwd_dkv_cuda.last_splits > 1
    for got, plain_out, ref in zip((o, lse, dq, dk, dv), plains, refs):
        err = (got.float() - ref).abs().max().item()
        plain_err = (plain_out.float() - ref).abs().max().item()
        assert err <= 2 * plain_err + 1e-3 * ref.abs().max().item(), (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["query_split", "no_split"])
@pytest.mark.parametrize("d", [128, 256, 96, 120])
def test_dkv_is_deterministic(d, path, cuda_device):
    """Two K3 launches on the same inputs give the same bits: with the query
    loop split over blocks (2 key tiles of 128, or 2 x 2 of 64 at D 256, on
    the card's SMs, summed in split order) and without (24 heads x 12 key
    tiles, or x 24 at D 256)."""
    sq, skv, h = (4096, 128, 2) if path == "query_split" else (256, 1536, 24)
    rng = np.random.default_rng(11)
    q, do = (torch.from_numpy(rng.standard_normal((1, sq, h, d), dtype=np.float32))
             .to(cuda_device, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, skv, h, d), dtype=np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    scale = d ** -0.5
    o, lse = port_fa.flash_fwd_cuda(q, k, v, None, scale)
    di = port_fa.row_dot(do, o)
    dk1, dv1 = port_fa.flash_bwd_dkv_cuda(q, k, v, None, lse, di, do, scale)
    splits = port_fa.flash_bwd_dkv_cuda.last_splits
    assert (splits > 1) == (path == "query_split")
    dk2, dv2 = port_fa.flash_bwd_dkv_cuda(q, k, v, None, lse, di, do, scale)
    torch.cuda.synchronize()
    assert port_fa.flash_bwd_dkv_cuda.last_splits == splits
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["flux", "wan_cross", "auraflow"])
def test_dq_is_deterministic(shape, cuda_device):
    """Two K2 launches on the same inputs give the same bits, at the shapes
    of the main paths (bf16): Flux-dev's joint attention (B 2, H 24, S 1536,
    D 128), Wan2.1's cross-attention (Sq 21504, Skv 512, H 12, D 128) and
    AuraFlow's joint attention (B 2, H 12, S 4360, D 256)."""
    b, sq, skv, h, d = {"flux": (2, 1536, 1536, 24, 128), "wan_cross": (1, 21504, 512, 12, 128),
                        "auraflow": (2, 4360, 4360, 12, 256)}[shape]
    rng = np.random.default_rng(17)
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, h, d), dtype=np.float32))
             .to(cuda_device, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, h, d), dtype=np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    scale = d ** -0.5
    o, lse = port_fa.flash_fwd_cuda(q, k, v, None, scale)
    di = port_fa.row_dot(do, o)
    dq1 = port_fa.flash_bwd_dq_cuda(q, k, v, None, lse, di, do, scale)
    dq2 = port_fa.flash_bwd_dq_cuda(q, k, v, None, lse, di, do, scale)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dq1).all()) and torch.equal(dq1, dq2)


@pytest.mark.cuda
@pytest.mark.parametrize("skv", [257, 514])
def test_image_cross_backward_is_deterministic(skv, cuda_device):
    """Two K2 and two K3 launches give the same bits at the i2v / flf2v
    image cross-attention (bf16, D 128, H 40, Sq 4096 against Skv 257 or
    514: a ragged last key tile, K3's query split)."""
    rng = np.random.default_rng(23)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4096, 40, 128), dtype=np.float32))
             .to(cuda_device, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, skv, 40, 128), dtype=np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    scale = 128 ** -0.5
    o, lse = port_fa.flash_fwd_cuda(q, k, v, None, scale)
    di = port_fa.row_dot(do, o)
    dq1 = port_fa.flash_bwd_dq_cuda(q, k, v, None, lse, di, do, scale)
    dq2 = port_fa.flash_bwd_dq_cuda(q, k, v, None, lse, di, do, scale)
    dk1, dv1 = port_fa.flash_bwd_dkv_cuda(q, k, v, None, lse, di, do, scale)
    dk2, dv2 = port_fa.flash_bwd_dkv_cuda(q, k, v, None, lse, di, do, scale)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in (dq1, dk1, dv1))
    assert torch.equal(dq1, dq2) and torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_sdxl_cross_shape_matches_plain(masked, cuda_device):
    """K1-K3 at SDXL's 512 px cross-attention (B 4, Sq 256, H 20, D 64,
    bf16) against the 77 CLIP tokens, one key tile with 51 padded keys
    (K3's query split), optionally with batch element 0 keeping 40 of the
    77: the error bound of test_kernels_match_plain_on_gpu; the masked keys
    get no dK / dV; K2 and K3 give the same bits twice."""
    b, sq, skv, h, d = 4, 256, 77, 20, 64
    rng = np.random.default_rng(19)
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, h, d), dtype=np.float32))
             .to(cuda_device, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, h, d), dtype=np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    mask = None
    if masked:
        mask = torch.ones((b, skv), dtype=torch.int32, device=cuda_device)
        mask[0, 40:] = 0
    scale = d ** -0.5

    def plain(q, k, v, do):
        o, lse = port_fa.flash_forward_plain(q, k, v, mask, scale)
        di = port_fa.row_dot(do, o)
        return (o, lse, port_fa.flash_bwd_dq_plain(q, k, v, mask, lse, di, do, scale),
                *port_fa.flash_bwd_dkv_plain(q, k, v, mask, lse, di, do, scale))

    refs = plain(q.float(), k.float(), v.float(), do.float())
    plains = plain(q, k, v, do)
    o, lse = port_fa.flash_fwd_cuda(q, k, v, mask, scale)
    di = port_fa.row_dot(do, o)
    dq = port_fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale)
    dk, dv = port_fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)
    assert port_fa.flash_bwd_dkv_cuda.last_splits > 1
    dq2 = port_fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale)
    dk2, dv2 = port_fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)
    torch.cuda.synchronize()
    for got, plain_out, ref in zip((o, lse, dq, dk, dv), plains, refs):
        err = (got.float() - ref).abs().max().item()
        plain_err = (plain_out.float() - ref).abs().max().item()
        assert err <= 2 * plain_err + 1e-3 * ref.abs().max().item(), (err, plain_err)
    if masked:
        assert torch.all(dk[0, 40:] == 0) and torch.all(dv[0, 40:] == 0)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


# (B, S, H, D, valid text keys of each batch element or None): SD3's joint
# sequence at 1024 px (77 CLIP + 256 T5 + 4,096 image tokens = 34 x 128 + 77
# keys, a ragged last tile), and Chroma's at 512 px (512 T5 + 1,024 image
# tokens) with 77 and 300 of the 512 T5 keys valid; fewer heads than the
# models' 24
SD3_CHROMA_CASES = {"sd3_1024": (1, 4429, 4, 64, None),
                    "chroma_512_masked": (2, 1536, 4, 128, (77, 300)),
                    # AuraFlow at 1024 px: 8 registers + 256 T5 rows + 4,096
                    # image tokens at D 256, unmasked and with 200 and 60 of
                    # the 256 T5 rows valid (the port's AuraFlow passes no
                    # mask; the kernels take one at every head dim)
                    "auraflow_1024": (2, 4360, 4, 256, None),
                    "auraflow_1024_masked": (2, 4360, 4, 256, (208, 68))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SD3_CHROMA_CASES))
def test_sd3_chroma_shapes_match_plain(case, cuda_device):
    """K1-K3 at SD3's, Chroma's and AuraFlow's joint-attention shapes (bf16): the error
    bound of test_kernels_match_plain_on_gpu; Chroma's masked T5 keys get
    no dK / dV; K2 and K3 give the same bits twice."""
    b, s, h, d, valid = SD3_CHROMA_CASES[case]
    rng = np.random.default_rng(29)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32))
                   .to(cuda_device, torch.bfloat16) for _ in range(4))
    mask = None
    txt = 264 if d == 256 else 512
    if valid is not None:
        mask = torch.ones((b, s), dtype=torch.int32, device=cuda_device)
        for i, n in enumerate(valid):
            mask[i, n:txt] = 0
    scale = d ** -0.5

    def plain(q, k, v, do):
        o, lse = port_fa.flash_forward_plain(q, k, v, mask, scale)
        di = port_fa.row_dot(do, o)
        return (o, lse, port_fa.flash_bwd_dq_plain(q, k, v, mask, lse, di, do, scale),
                *port_fa.flash_bwd_dkv_plain(q, k, v, mask, lse, di, do, scale))

    refs = plain(q.float(), k.float(), v.float(), do.float())
    plains = plain(q, k, v, do)
    o, lse = port_fa.flash_fwd_cuda(q, k, v, mask, scale)
    di = port_fa.row_dot(do, o)
    dq = port_fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale)
    dk, dv = port_fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)
    dq2 = port_fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale)
    dk2, dv2 = port_fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)
    torch.cuda.synchronize()
    for got, plain_out, ref in zip((o, lse, dq, dk, dv), plains, refs):
        err = (got.float() - ref).abs().max().item()
        plain_err = (plain_out.float() - ref).abs().max().item()
        assert err <= 2 * plain_err + 1e-3 * ref.abs().max().item(), (err, plain_err)
    if valid is not None:
        for i, n in enumerate(valid):
            assert torch.all(dk[i, n:txt] == 0) and torch.all(dv[i, n:txt] == 0)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["query_split", "no_split"])
@pytest.mark.parametrize("d", [128, 64, 256, 96, 120])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_all_masked_batch_element_gives_zeros(dtype, d, path, cuda_device):
    """Batch element 0 has no valid key: O = 0, LSE = DEFAULT_MASK_VALUE and
    dQ = dK = dV = 0 from the kernels, on K3's split path (4 key tiles) and
    without it (2 x 24 heads x 3 key tiles); element 1 keeps a random mask
    and its O, dQ, dK and dV match the plain version."""
    sq, skv, h = (4096, 128, 2) if path == "query_split" else (256, 384, 24)
    rng = np.random.default_rng(13)
    q, do = (torch.from_numpy(rng.standard_normal((2, sq, h, d), dtype=np.float32))
             .to(cuda_device, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, skv, h, d), dtype=np.float32))
            .to(cuda_device, dtype) for _ in range(2))
    mask = torch.from_numpy((rng.random((2, skv)) > 0.3).astype(np.int32)).to(cuda_device)
    mask[0] = 0
    scale = d ** -0.5
    o, lse = port_fa.flash_fwd_cuda(q, k, v, mask, scale)
    di = port_fa.row_dot(do, o)
    dq = port_fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale)
    dk, dv = port_fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)
    torch.cuda.synchronize()
    assert (port_fa.flash_bwd_dkv_cuda.last_splits > 1) == (path == "query_split")
    for x in (o, dq, dk, dv):
        assert bool(torch.isfinite(x).all()) and bool((x[0] == 0).all())
    assert bool((lse[0] == port_fa.DEFAULT_MASK_VALUE).all())

    def plain(q, k, v, do):
        o, lse = port_fa.flash_forward_plain(q, k, v, mask, scale)
        di = port_fa.row_dot(do, o)
        return (o, port_fa.flash_bwd_dq_plain(q, k, v, mask, lse, di, do, scale),
                *port_fa.flash_bwd_dkv_plain(q, k, v, mask, lse, di, do, scale))

    refs = plain(q.float(), k.float(), v.float(), do.float())
    for got, plain_out, ref in zip((o, dq, dk, dv), plain(q, k, v, do), refs):
        err = (got[1].float() - ref[1]).abs().max().item()
        plain_err = (plain_out[1].float() - ref[1]).abs().max().item()
        assert err <= 2 * plain_err + 1e-3 * ref[1].abs().max().item(), (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256, 96, 120])
def test_autograd_runs_the_kernels(d, cuda_device):
    """flash_attention on CUDA tensors: forward and backward go through
    K1, K2 and K3 once each (at D 256 K1's and K2's entries of every head
    dim and K3's own), and the grads match the plain backward."""
    q, k, v, do, _ = _inputs("ragged", cuda_device, d=d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    port_fa.reset_launch_counts()
    o, _ = port_fa.flash_attention(*leaves)
    o.backward(do)
    assert port_fa.launch_counts() == {
        "flash_fwd_cuda": 1, "flash_bwd_dq_cuda": 1, "flash_bwd_dkv_cuda": 1}
    if d == 256:
        assert port_fa._symbol("dpt_flash_fwd", d) == "dpt_flash_fwd"
        assert port_fa._symbol("dpt_flash_bwd_dq", d) == "dpt_flash_bwd_dq"
        assert port_fa._SIGNATURES["dpt_flash_bwd_dq"][0] == "flash_bwd_dq"
        assert port_fa._SIGNATURES[port_fa._symbol("dpt_flash_bwd_dkv", d)][0] == \
            "flash_bwd_dkv_d256"
    scale = d ** -0.5
    qf, kf, vf = (x.float() for x in (q, k, v))
    ro, rlse = port_fa.flash_forward_plain(qf, kf, vf, None, scale)
    di = port_fa.row_dot(do.float(), ro)
    rdq = port_fa.flash_bwd_dq_plain(qf, kf, vf, None, rlse, di, do.float(), scale)
    rdk, rdv = port_fa.flash_bwd_dkv_plain(qf, kf, vf, None, rlse, di, do.float(), scale)
    for leaf, ref in zip(leaves, (rdq, rdk, rdv)):
        assert (leaf.grad.float() - ref).abs().max().item() < 2e-2 * ref.abs().max().item()


def _plain_all(q, k, v, do, mask, scale):
    o, lse = port_fa.flash_forward_plain(q, k, v, mask, scale)
    di = port_fa.row_dot(do, o)
    return (o, lse, port_fa.flash_bwd_dq_plain(q, k, v, mask, lse, di, do, scale),
            *port_fa.flash_bwd_dkv_plain(q, k, v, mask, lse, di, do, scale))


def _kernels_all(q, k, v, do, mask, scale):
    o, lse = port_fa.flash_fwd_cuda(q, k, v, mask, scale)
    di = port_fa.row_dot(do, o)
    return (o, lse, port_fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale),
            *port_fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale))


def _assert_near_plain(got, q, k, v, do, mask, scale):
    refs = _plain_all(q.float(), k.float(), v.float(), do.float(), mask, scale)
    for g, p, r in zip(got, _plain_all(q, k, v, do, mask, scale), refs):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        err = (g.float() - r).abs().max().item()
        plain_err = (p.float() - r).abs().max().item()
        assert err <= 2 * plain_err + 1e-3 * r.abs().max().item(), (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 120])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case, sq, skv, h, masked", [
    ("ragged_masked", 200, 1000, 24, True), ("query_split", 4096, 128, 3, False)])
def test_padded_head_dims_touch_only_d_columns(case, sq, skv, h, masked, dtype, d, cuda_device):
    """Q, K, V and dO as column slices [..., :D] of [B, S, H, 128] buffers
    whose columns past D hold NaN: a read past D would spread NaN into the
    outputs. The outputs (contiguous, heads D apart) match the plain
    versions in every column, so no store past D lands on the next head;
    on both of K3's paths (2 x 24 heads x 8 key tiles fill the card; 2 x 3
    x 1 split the query loop)."""
    rng = np.random.default_rng(17)
    views = []
    for s in (sq, skv, skv, sq):
        buf = torch.full((2, s, h, 128), float("nan"), dtype=dtype, device=cuda_device)
        buf[..., :d] = torch.from_numpy(rng.standard_normal((2, s, h, d), dtype=np.float32)).to(
            cuda_device, dtype)
        views.append(buf[..., :d])
    q, k, v, do = views
    assert q.stride() == (sq * h * 128, h * 128, 128, 1)
    mask = None
    if masked:
        mask = torch.from_numpy((rng.random((2, skv)) > 0.3).astype(np.int32)).to(cuda_device)
    scale = d ** -0.5
    got = _kernels_all(q, k, v, do, mask, scale)
    torch.cuda.synchronize()
    assert (port_fa.flash_bwd_dkv_cuda.last_splits > 1) == (case == "query_split")
    _assert_near_plain(got, *(x.contiguous() for x in views), mask, scale)


# Lumina 2's and OmniGen2's joint sequences at 1024 px (256 caption rows, 60
# and 200 of them valid, then 4,096 image tokens) and Lumina 2's noise
# refiner (the 4,096 image tokens, unmasked), at 3 heads:
# name: (B, S, D, masked keys of each batch element)
LUMINA_CASES = {"lumina2_4352_masked": (2, 4352, 96, (slice(60, 256), slice(200, 256))),
                "lumina2_refiner_4096": (2, 4096, 96, None),
                "omnigen2_4352_masked": (1, 4352, 120, (slice(60, 256),))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LUMINA_CASES))
def test_lumina_shapes_match_plain(case, cuda_device):
    """K1-K3 at the Lumina families' shapes against the plain versions; K2
    and K3 give the same bits twice there."""
    b, s, d, masked = LUMINA_CASES[case]
    rng = np.random.default_rng(19)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, 3, d), dtype=np.float32))
                   .to(cuda_device, torch.bfloat16) for _ in range(4))
    mask = None
    if masked:
        mask = torch.ones((b, s), dtype=torch.int32, device=cuda_device)
        for i, keys in enumerate(masked):
            mask[i, keys] = 0
    scale = d ** -0.5
    got = _kernels_all(q, k, v, do, mask, scale)
    _assert_near_plain(got, q, k, v, do, mask, scale)
    again = _kernels_all(q, k, v, do, mask, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got[2:], again[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_hidream_shape_matches_plain(dtype, cuda_device):
    """K1-K3 at HiDream-I1's joint sequence at 1024 px (B 1, 4,480 rows =
    4,096 image + 128 T5 + 2 x 128 Llama, all 20 heads of 128, unmasked)
    against the plain versions; K2 and K3 give the same bits twice."""
    rng = np.random.default_rng(23)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 4480, 20, 128), dtype=np.float32))
                   .to(cuda_device, dtype) for _ in range(4))
    scale = 128 ** -0.5
    got = _kernels_all(q, k, v, do, None, scale)
    _assert_near_plain(got, q, k, v, do, None, scale)
    again = _kernels_all(q, k, v, do, None, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got[2:], again[2:]))


# The Cosmos families' attention at heads of 128, unmasked, on 4 heads:
# Cosmos-1's self-attention at 960 x 704 (2,640 rows, a ragged last tile)
# and Predict2 / Anima's cross-attention at 1024 px (4,096 image rows to 512
# T5 rows): name: (B, Sq, Skv)
COSMOS_CASES = {"cosmos1_self_2640": (1, 2640, 2640),
                "predict2_cross_4096x512": (2, 4096, 512)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(COSMOS_CASES))
def test_cosmos_shapes_match_plain(case, dtype, cuda_device):
    """K1-K3 at the Cosmos shapes against the plain versions; K2 and K3
    give the same bits twice."""
    b, sq, skv = COSMOS_CASES[case]
    rng = np.random.default_rng(29)
    q, do, k, v = (torch.from_numpy(rng.standard_normal((b, s, 4, 128), dtype=np.float32))
                   .to(cuda_device, dtype) for s in (sq, sq, skv, skv))
    scale = 128 ** -0.5
    got = _kernels_all(q, k, v, do, None, scale)
    _assert_near_plain(got, q, k, v, do, None, scale)
    again = _kernels_all(q, k, v, do, None, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got[2:], again[2:]))


# The Hunyuan families' attention at heads of 128 with their padded text keys
# masked, on 4 heads: HunyuanVideo's joint sequence for a 33-frame 512 px
# clip (9,216 image rows + 256 LLaVA rows, 60 valid) and its refiner's 256
# rows; HunyuanImage-2.1's at 2048 px (4,096 image rows + 128 byT5 rows, 12
# valid, + 966 Qwen rows, 80 valid: masked keys in the middle of the
# sequence, a ragged last tile) and its refiner's 966 rows: name: (S, the
# valid ranges of the keys)
HUNYUAN_CASES = {"hunyuan_video_joint_9472": (9472, ((0, 9276),)),
                 "hunyuan_video_refiner_256": (256, ((0, 60),)),
                 "hunyuan_image_joint_5190": (5190, ((0, 4108), (4224, 4304))),
                 "hunyuan_image_refiner_966": (966, ((0, 80),))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(HUNYUAN_CASES))
def test_hunyuan_shapes_match_plain(case, dtype, cuda_device):
    """K1-K3 at the Hunyuan shapes against the plain versions; the padded
    keys get no dK / dV; K2 and K3 give the same bits twice."""
    s, valid = HUNYUAN_CASES[case]
    rng = np.random.default_rng(31)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, s, 4, 128), dtype=np.float32))
                   .to(cuda_device, dtype) for _ in range(4))
    mask = torch.zeros((1, s), dtype=torch.int32, device=cuda_device)
    for lo, hi in valid:
        mask[:, lo:hi] = 1
    scale = 128 ** -0.5
    got = _kernels_all(q, k, v, do, mask, scale)
    _assert_near_plain(got, q, k, v, do, mask, scale)
    padded = mask[0] == 0
    assert not got[3][0, padded].any() and not got[4][0, padded].any()
    again = _kernels_all(q, k, v, do, mask, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got[2:], again[2:]))


# HunyuanVideo-1.5's and the LTX families' attention on 4 heads:
# HunyuanVideo-1.5's joint sequence for a 33-frame 512 px clip (9,216 image
# rows + 128 byT5 rows, 12 valid, + 966 Qwen rows, 80 valid) at D 128; LTX's
# 6,144 tokens of a 121-frame 768 x 512 clip, their cross-attention to 128
# T5 rows (40 valid) at D 64; LTX-2's cross-attention to the connector's
# 1,024 rows at D 128 and the connector's own at D 64: name: (Sq, Skv, D,
# the valid ranges of the keys or None)
LTX_HV15_CASES = {"hv15_joint_10310": (10310, 10310, 128, ((0, 9228), (9344, 9424))),
                  "ltx_self_6144": (6144, 6144, 64, None),
                  "ltx_cross_6144x128": (6144, 128, 64, ((0, 40),)),
                  "ltx2_cross_6144x1024": (6144, 1024, 128, None),
                  "ltx2_connector_1024": (1024, 1024, 64, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(LTX_HV15_CASES))
def test_ltx_hv15_shapes_match_plain(case, dtype, cuda_device):
    """K1-K3 at the HunyuanVideo-1.5 and LTX shapes against the plain
    versions; the padded keys get no dK / dV; K2 and K3 give the same bits
    twice."""
    sq, skv, d, valid = LTX_HV15_CASES[case]
    rng = np.random.default_rng(37)
    q, do, k, v = (torch.from_numpy(rng.standard_normal((1, s, 4, d), dtype=np.float32))
                   .to(cuda_device, dtype) for s in (sq, sq, skv, skv))
    mask = None
    if valid is not None:
        mask = torch.zeros((1, skv), dtype=torch.int32, device=cuda_device)
        for lo, hi in valid:
            mask[:, lo:hi] = 1
    scale = d ** -0.5
    got = _kernels_all(q, k, v, do, mask, scale)
    _assert_near_plain(got, q, k, v, do, mask, scale)
    if mask is not None:
        padded = mask[0] == 0
        assert not got[3][0, padded].any() and not got[4][0, padded].any()
    again = _kernels_all(q, k, v, do, mask, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got[2:], again[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 80, 112])
def test_unsupported_head_dims_raise_on_the_card(d, cuda_device):
    """Head dims the kernels do not take raise before a launch: no SDPA or
    plain fallback for CUDA tensors."""
    x = torch.zeros((1, 64, 2, d), dtype=torch.bfloat16, device=cuda_device)
    port_fa.reset_launch_counts()
    with pytest.raises(ValueError, match="head dim"):
        port_fa.flash_attention(x, x, x)
    assert sum(port_fa.launch_counts().values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("udtype", [torch.bfloat16, torch.float32])
def test_stochastic_round_kernel_matches_plain(udtype, cuda_device):
    n = 8 * 1000 + 5  # a ragged tail of 5
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    u = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-2).to(udtype)
    p[:4] = torch.tensor([float("nan"), float("inf"), -float("inf"), 1.5])
    u[:4] = 0.0  # special and exact values pass through
    p, u = p.to(cuda_device), u.to(cuda_device)
    want = quant.sr_add_plain(p, u, 12345)
    got = p.clone()
    quant.reset_launch_counts()
    assert quant.sr_add_cuda(got, u, 12345) is got
    torch.cuda.synchronize()
    assert quant.launch_counts() == {"sr_add_cuda": 1}
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.isnan(got[0]) and got[1] == float("inf") and got[2] == -float("inf")
    assert got[3] == 1.5
    # every other output is one of the two bf16 neighbours of x = p + u
    trunc = (p.float() + u.float())[4:].view(torch.int32) & -65536  # toward zero
    g = got[4:].float()
    assert bool(((g == trunc.view(torch.float32)) | (g == (trunc + 65536).view(torch.float32))).all())


# --- H1 / H2 around the int8 product ---------------------------------------------


def _quant_inputs(rows, cols, dtype, dev, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)) * np.exp(rng.standard_normal((rows, 1)))
    x[0, :] = 0.0  # a zero row: scale 0, int8 0
    x[-1, 3] = 1e3  # a large outlier that sets its row's scale
    col = (0.5 + rng.random(cols)).astype(np.float32)
    return (torch.from_numpy(x.astype(np.float32)).to(dev, dtype),
            torch.from_numpy(col).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2, 17, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("prescale", [False, True])
def test_quant_rows_kernel_matches_plain(rows, dtype, prescale, cuda_device):
    """H1 bit for bit against its plain version (the JAX expression in
    torch), on the card: int8 image and f32 scales, with and without the
    per-column pre-scale, on a contiguous input and on a row-strided view."""
    x, col = _quant_inputs(rows, 3072, dtype, cuda_device)
    col = col if prescale else None
    int8_quant.reset_launch_counts()
    for xin in (x, torch.cat([x, x], dim=1)[:, 3072:]):
        got8, got_s = int8_quant.quant_rows_cuda(xin, col)
        want8, want_s = int8_quant.quant_rows_plain(xin, col)
        torch.cuda.synchronize()
        assert got8.dtype == torch.int8 and got_s.shape == (rows, 1)
        assert torch.equal(got8, want8)
        assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    assert int8_quant.launch_counts()["quant_rows_cuda"] == 2
    assert not got8[0].any() and got_s[0].item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2, 17, 2048])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_rescale_kernel_matches_plain(rows, out_dtype, cuda_device):
    """H2 bit for bit against its plain version: both scales, only the row
    scale (the bwd8 dgrads), and a row-strided int32 input."""
    rng = np.random.default_rng(6)
    y = torch.from_numpy(rng.integers(-2 ** 24, 2 ** 24, (rows, 1024), dtype=np.int32))
    rs = torch.from_numpy((rng.random((rows, 1)) * 1e-3).astype(np.float32))
    cs = torch.from_numpy((rng.random(1024) * 1e-2).astype(np.float32))
    y, rs, cs = (t.to(cuda_device) for t in (y, rs, cs))
    for yin, r, c in ((y, rs, cs), (y, rs, None), (torch.cat([y, y], 1)[:, 512:1536], rs, cs)):
        got = int8_quant.rescale_i32_cuda(yin, r, c, out_dtype)
        want = int8_quant.rescale_i32_plain(yin, r, c, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_int_mm_padding_path(cuda_device):
    """torch._int_mm refuses 16 rows or fewer on the card; int_mm pads 2 and
    16 rows to 32 and gives the CPU product's bits (17 rows go straight)."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.integers(-127, 128, (18432, 3072), dtype=np.int8))
    for rows in (2, 16, 17):
        a = torch.from_numpy(rng.integers(-127, 128, (rows, 3072), dtype=np.int8))
        want = torch._int_mm(a, w.t())
        got = int8_quant.int_mm(a.to(cuda_device), w.to(cuda_device).t())
        torch.cuda.synchronize()
        assert got.shape == (rows, 18432) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2, 2048])
def test_int8_pq_dot_bwd8_matches_cpu(rows, cuda_device):
    """int8_pq_dot_bwd8 (the Flux path's int8 linear) on the card through
    H1, torch._int_mm and H2, forward and dgrad, against the plain path on
    the CPU: the same bits, and one H1 and one H2 launch each way."""
    from diffusion_pipe_tpu_torch.models import layers

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((rows, 3072)).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((rows, 1024)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((1024, 3072)) / 55).astype(np.float32))
    w8, scale = layers.quantize_kernel_int8(w.to(torch.float8_e4m3fn))
    outs = {}
    for dev in ("cpu", cuda_device):
        xd = x.to(dev).detach().requires_grad_(True)
        int8_quant.reset_launch_counts()
        y = layers.int8_pq_dot_bwd8(xd, w8.to(dev), scale.to(dev))
        y.backward(g.to(dev))
        outs[str(dev)] = (y.detach().cpu(), xd.grad.cpu(), int8_quant.launch_counts())
    (y_cpu, dx_cpu, n_cpu), (y_gpu, dx_gpu, n_gpu) = outs.values()
    assert torch.equal(y_gpu, y_cpu) and torch.equal(dx_gpu, dx_cpu)
    assert n_cpu == {"quant_rows_cuda": 0, "rescale_i32_cuda": 0}
    assert n_gpu == {"quant_rows_cuda": 2, "rescale_i32_cuda": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["wan_vae", "umt5"])
def test_wan_encoders_on_card_match_cpu(model, cuda_device):
    """The tiny Wan 2.1 VAE (the pipeline's `_tiny` widths) on a 9-frame 32 px
    clip, encode then decode, and tiny UMT5 on 2 x 16 ids (the second padded
    after 9), f32 with TF32 off, on the card against the same weights on the
    CPU: within 1e-4 of the largest magnitude (cuDNN and cuBLAS sum in
    another order)."""
    from diffusion_pipe_tpu_torch.models.umt5 import UMT5Config, UMT5Encoder
    from diffusion_pipe_tpu_torch.models.wan_vae import WanVAEConfig, WanVideoVAE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    if model == "wan_vae":
        cpu = WanVideoVAE(WanVAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 4), num_res_blocks=1,
                                       temperal_downsample=(True, True)))
        cpu.init_weights(g)
        x = torch.rand((1, 3, 9, 32, 32), generator=g) * 2 - 1

        def run(m, x):
            return m.decode(m.encode(x))
    else:
        cpu = UMT5Encoder(UMT5Config.tiny())
        cpu.init_weights(g)
        ids = torch.randint(0, 128, (2, 16), generator=g)
        mask = torch.ones((2, 16), dtype=torch.int32)
        mask[1, 9:] = 0
        x = (ids, mask)

        def run(m, x):
            return m(*x)
    card = type(cpu)(cpu.config if model == "wan_vae" else cpu.cfg).to(cuda_device)
    card.load_state_dict(cpu.state_dict())
    x_card = (x.to(cuda_device) if model == "wan_vae"
              else tuple(t.to(cuda_device) for t in x))
    with torch.no_grad():
        want, got = run(cpu, x), run(card, x_card).cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())



def _policy_block(dev):
    """A block of three LoRA linears with dropout around K1 (2 heads of 128)
    and its parameters, bf16 on the card."""
    from diffusion_pipe_tpu_torch.models.layers import LoraDense

    g = torch.Generator(device=dev).manual_seed(3)
    lin = [LoraDense(256, 256, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                     lora_rank=8, lora_alpha=8.0, lora_dropout=0.1,
                     lora_dtype=torch.bfloat16).to(dev) for _ in range(3)]
    for m in lin:
        m.init_weights(g)
        with torch.no_grad():
            m.lora_b.normal_(0.0, 0.05, generator=g)

    def block(x):
        b, s, _ = x.shape
        q = lin[0](x).reshape(b, s, 2, 128)
        kv = lin[1](x).reshape(b, s, 2, 128)
        o = port_fa.flash_attention(q, kv, kv)[0].reshape(b, s, 256)
        return lin[2](o)

    return block, [p for m in lin for p in (m.lora_a, m.lora_b)]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["offload_attn", "unsloth"])
def test_offload_policy_waits_for_its_copies(policy, cuda_device, monkeypatch):
    """The offload policies' host copies run on a side stream, delayed here
    by a spin of 2e7 cycles before each: the recompute must wait for them
    (an event a copy) and the caching allocator must not hand a tensor's
    memory on before its copy has read it (record_stream). The loss and
    the LoRA gradients equal true's bit for bit, with the same dropout
    masks; the pinned slabs held the saved tensors."""
    from diffusion_pipe_tpu_torch.models import layers
    from diffusion_pipe_tpu_torch.ops import offload

    block, params = _policy_block(cuda_device)
    x = torch.randn((2, 256, 256), generator=torch.Generator(device=cuda_device).manual_seed(4),
                    device=cuda_device, dtype=torch.bfloat16, requires_grad=True)

    def run(spec):
        for p in params + [x]:
            p.grad = None
        with layers.adapter_dropout(layers.KeepMasks(9)):
            y = layers.remat_call(spec, block, x)
            # churn the allocator while the copies are pending
            junk = [torch.empty_like(y).fill_(7.0) for _ in range(4)]
            loss = (y.float() ** 2).mean()
        del junk
        loss.backward()
        return loss.detach(), [g.grad.clone() for g in params + [x]]

    want = run("full")
    offload.reset_stats()
    real_stream = torch.cuda.stream

    @contextlib.contextmanager
    def delayed_stream(stream):
        # every work queued on the side stream starts behind the spin
        with real_stream(stream):
            torch.cuda._sleep(20_000_000)
            yield

    monkeypatch.setattr(torch.cuda, "stream", delayed_stream)
    got = run(policy)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert offload.stats["peak"] > 0 and offload.stats["held"] == 0
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sampler_launches_only_the_forward(cuda_device):
    """FluxPipeline.sample under "attn" checkpointing: K1 once a block a step
    (a two-block Flux at head dim 128), no K2 or K3, no graph."""
    import dataclasses

    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.models.flux_model import FluxConfig, FluxTransformer
    from diffusion_pipe_tpu_torch.models.layers import init_module_weights

    cfg = {"save_every_n_epochs": 1, "activation_checkpointing": "attn",
           "model": {"type": "flux", "dtype": "bfloat16", "_tiny": True}}
    pipe = get_model_class("flux")(cfg, device=cuda_device)
    pipe.flux_config = dataclasses.replace(
        FluxConfig.tiny(), num_layers=1, num_single_layers=1, attention_head_dim=128,
        num_attention_heads=2, axes_dims_rope=(16, 56, 56), dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, remat="attn")
    with torch.device(cuda_device):
        pipe.model = FluxTransformer(pipe.flux_config)
    init_module_weights(pipe.model, torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    t5 = torch.randn((1, 8, 64), generator=g, device=cuda_device)
    clip = torch.randn((1, 32), generator=g, device=cuda_device)
    port_fa.reset_launch_counts()
    lat = pipe.sample(t5, clip, 64, 64, generator=g, num_steps=3)
    counts = port_fa.launch_counts()
    assert tuple(lat.shape) == (1, 16, 8, 8) and not lat.requires_grad
    assert bool(torch.isfinite(lat).all())
    assert counts == {"flash_fwd_cuda": 3 * 2, "flash_bwd_dq_cuda": 0, "flash_bwd_dkv_cuda": 0}
