"""The port's W8A8 int8 linears and fp8 storage against the JAX package's.

The same numpy inputs from a seed go through the JAX functions of
diffusion_pipe_tpu/models/layers.py (int8_dot, int8_dot_bwd8, int8_pq_dot,
int8_pq_dot_bwd8, quantize_kernel_int8, prequantize_int8_tree) and their
counterparts in the port, whose kernel [in, out] is the port's weight
[out, in] transposed. The JAX side runs op by op, as its expressions are
written: under jit, XLA's CPU compiler turns `max|x| / 127.0` into a
multiply by the reciprocal, whose scales differ from the division by up to
one f32 ulp, while the port divides as the expression does.

Bit for bit: the int8 images, the int32 accumulators, every forward output
and the int8 dgrads (bwd8). Within a tolerance: the float dgrads of int8_dot
(f32 products) and int8_pq_dot (bf16 products summed in f32), summed in
another order, within one bf16 ulp of their largest magnitude in bf16 and
1e-6 of it in f32. The weight cotangents are zero, trainable or not.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models import layers as jl
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import layers as tl
from diffusion_pipe_tpu_torch.ops import int8_quant as iq
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import bf16_ulp, random_params, tiny_flux_config

IN, OUT = 40, 48
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rows, seed=0):
    rng = np.random.default_rng(seed)
    # rows of very different magnitudes, so the per-row scales matter
    x = rng.standard_normal((rows, IN)) * np.exp(rng.standard_normal((rows, 1)))
    w = rng.standard_normal((IN, OUT)) / np.sqrt(IN)  # the JAX kernel [in, out]
    g = rng.standard_normal((rows, OUT)) * np.exp(rng.standard_normal((rows, 1)))
    return x.astype(np.float32), w.astype(np.float32), g.astype(np.float32)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH_DTYPES[dtype])


def _np(t):
    return t.detach().float().numpy()


def _jint_mm(a8, b8, contract_b):
    return np.asarray(jax.lax.dot_general(
        jnp.asarray(a8), jnp.asarray(b8), (((1,), (contract_b,)), ((), ())),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("rows,dtype", [(2, "float32"), (24, "bfloat16")])
@pytest.mark.parametrize("name", ["int8_dot", "int8_dot_bwd8", "int8_pq_dot",
                                  "int8_pq_dot_bwd8"])
def test_int8_linear_matches_jax(name, rows, dtype):
    x, w, g = _inputs(rows)
    jdt = JAX_DTYPES[dtype]
    xj, wj, gj = (jnp.asarray(a, jdt) for a in (x, w, g))
    pre = "pq" in name
    # the JAX side: forward output (cast to the layer's dtype, as LoraDense
    # casts it), dx, and the weight-side cotangent
    if pre:
        w8j, sj = jl.quantize_kernel_int8(wj)
        out_j, vjp = jax.vjp(lambda a, s: getattr(jl, name)(a, w8j, s), xj, sj)
    else:
        out_j, vjp = jax.vjp(getattr(jl, name), xj, wj)
    dx_j, dw_j = vjp(gj.astype(jnp.float32))  # the f32 result's cotangent
    out_j = np.asarray(out_j.astype(jdt).astype(jnp.float32))

    xt = _t(x, dtype).requires_grad_(True)
    wt = _t(w.T, dtype)
    if pre:
        w8t, st = tl.quantize_kernel_int8(wt)
        st.requires_grad_(True)
        out_t = getattr(tl, name)(xt, w8t, st)
        weight_side = st
    else:
        wt.requires_grad_(True)  # a trainable kernel still gets zeros
        w8t, st = tl.quantize_kernel_int8(wt.detach())
        out_t = getattr(tl, name)(xt, wt)
        weight_side = wt
    out_t.backward(_t(g, dtype))

    # int8 images and int32 accumulators of the forward
    x8j, xsj = jl._quant_rows(xj)
    x8t, xst = iq.quant_rows_plain(xt.detach())
    w8_ref, ws_ref = jl.quantize_kernel_int8(wj)
    np.testing.assert_array_equal(x8t.numpy(), np.asarray(x8j))
    np.testing.assert_array_equal(xst.numpy(), np.asarray(xsj))
    np.testing.assert_array_equal(w8t.numpy(), np.asarray(w8_ref).T)
    np.testing.assert_array_equal(st.detach().numpy(), np.asarray(ws_ref))
    np.testing.assert_array_equal(iq.int_mm(x8t, w8t.t()).numpy(),
                                  _jint_mm(x8j, w8_ref, 0))
    assert out_t.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_array_equal(_np(out_t), out_j)

    # int8 images and int32 accumulators of the int8 dgrads
    gf = gj.astype(jnp.float32)
    if name == "int8_pq_dot_bwd8":
        g8j, _ = jl._quant_rows(gf * ws_ref[None, :])
        g8t, _ = iq.quant_rows_plain(_t(g, dtype), st.detach())
        np.testing.assert_array_equal(g8t.numpy(), np.asarray(g8j))
        np.testing.assert_array_equal(iq.int_mm(g8t, w8t.t().contiguous().t()).numpy(),
                                      _jint_mm(g8j, w8_ref, 1))
    elif name == "int8_dot_bwd8":
        g8j, _ = jl._quant_rows(gf)
        wi8j, _ = jl._quant_rows(wj.astype(jnp.float32))  # per input channel
        g8t, _ = iq.quant_rows_plain(_t(g, dtype))
        wi8t, _ = iq.quant_rows_plain(wt.detach().t())
        np.testing.assert_array_equal(wi8t.numpy(), np.asarray(wi8j))
        np.testing.assert_array_equal(iq.int_mm(g8t, wi8t.t()).numpy(),
                                      _jint_mm(g8j, wi8j, 1))

    dx_j = np.asarray(dx_j.astype(jnp.float32))
    if name.endswith("bwd8"):
        np.testing.assert_array_equal(_np(xt.grad), dx_j)
    else:
        tol = (bf16_ulp(np.abs(dx_j).max()) if dtype == "bfloat16"
               else 1e-6 * np.abs(dx_j).max())
        assert np.abs(_np(xt.grad) - dx_j).max() <= tol
    assert not np.asarray(dw_j, np.float32).any()
    assert weight_side.grad is not None and not weight_side.grad.float().any()


def test_int_mm_pads_short_inputs():
    """Two rows (the adaLN linears' batch) go through 32 padded rows and
    give the unpadded product's bits."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-127, 128, (2, 64), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (24, 64), dtype=np.int8))
    got = iq.int_mm(a, b.t())
    assert got.shape == (2, 24) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int32) @ b.numpy().T)


def test_float8_cast_matches_ml_dtypes():
    """torch's f32 -> float8_e4m3fn against ml_dtypes' and XLA's, over the
    fp8 subnormals (|x| < 2^-6, where lecun-normal weights of a wide layer
    sit) and normal values, rounding ties included."""
    rng = np.random.default_rng(2)
    sub = np.arange(-64, 65, dtype=np.float32) * 2.0 ** -13  # quarter steps of 2^-9
    vals = np.concatenate([
        sub, np.linspace(-2.0 ** -6, 2.0 ** -6, 997, dtype=np.float32),
        (rng.standard_normal(2000) * 0.02).astype(np.float32),
        np.array([0.0, -0.0, 2.0 ** -9, 1.5 * 2.0 ** -9, 2.5 * 2.0 ** -9, 1.0625, 448.0,
                  -448.0, 1.0 / 3.0], np.float32)])
    want = vals.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = torch.from_numpy(vals).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    xla = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(got, xla)


def test_prequantize_matches_jax():
    """prequantize_int8_ on the tiny Flux (fp8 block weights, int8 fwd_bwd)
    against prequantize_int8_tree on the frozen tree, after the fp8 weights
    cross through interop.py: int8 weights and scales bit for bit, every
    block linear int8, the embedders and head untouched."""
    cfg = tiny_flux_config()
    cfg["model"] = dict(cfg["model"], transformer_dtype="float8", int8_matmul="fwd_bwd")
    jpipe = jax_model_class("flux")(cfg)
    params = random_params(jpipe, seed=3)
    ref = jax_to_state_dict(jl.prequantize_int8_tree(params))

    pipe = get_model_class("flux")(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    pipe.model.load_state_dict(jax_to_state_dict(params))
    assert pipe.model.double_blocks[0].ff_in.weight.dtype == torch.float8_e4m3fn
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(n.endswith(("lora_a", "lora_b")))
    assert tl.prequantize_int8_(pipe.model) == 2 * 14 + 2 * 6
    got = pipe.model.state_dict()
    assert set(got) == set(ref)
    int8 = [k for k, v in got.items() if v.dtype == torch.int8]
    assert len(int8) == 40 and all(k.startswith(("double_blocks", "single_blocks"))
                                   for k in int8)
    for k, v in got.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v.view(torch.uint8).numpy() if v.element_size() == 1
                                      else v.numpy(),
                                      ref[k].view(torch.uint8).numpy()
                                      if v.element_size() == 1 else ref[k].numpy(),
                                      err_msg=k)
