"""The port's UMT5 encoder (models/umt5.py) against the JAX package's, on the
same weights (carried by interop.tree_to_state_dict).

Tiny config (2 layers, dim 32, 4 heads, vocabulary 128), a batch of two
16-token captions, the second padded after 9 tokens. f32: the hidden
states agree within 1e-5 of their largest magnitude (the same f32
arithmetic, summed in another order), with the matmul weights in f32 and
stored in float8 (text_encoder_fp8: the same tensors cast to the same bits
by cast_te_params_fp8, then cast back at use). convert_umt5_comfy of the
same ComfyUI-layout checkpoint gives the same state dict in both packages,
bit for bit; relative_position_buckets gives the same buckets.
"""

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from diffusion_pipe_tpu.models import umt5 as jumt5
from diffusion_pipe_tpu.models.text_encoders import cast_te_params_fp8 as jcast_fp8
from diffusion_pipe_tpu_torch.interop import tree_to_state_dict
from diffusion_pipe_tpu_torch.models import umt5 as pumt5
from diffusion_pipe_tpu_torch.models.text_encoders import cast_te_params_fp8
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE


def _inputs():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    ids[1, 9:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def jax_side():
    cfg = jumt5.UMT5Config.tiny()
    enc = jumt5.UMT5Encoder(cfg)
    ids, mask = _inputs()
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(0), ids, mask)
    rng = np.random.default_rng(5)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("norm1", "norm2", "final_norm"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[0] if name == "kernel" else 1
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = nn.unbox(jax.tree_util.tree_map_with_path(fill, shapes))
    fp8 = jcast_fp8(params)
    run = jax.jit(enc.apply, compiler_options=JAX_FAST_COMPILE)
    outs = {"f32": np.asarray(run(params, ids, mask)), "fp8": np.asarray(run(fp8, ids, mask))}
    return cfg, params, fp8, outs


def _port(params):
    enc = pumt5.UMT5Encoder(pumt5.UMT5Config.tiny())
    enc.load_state_dict(tree_to_state_dict(params), assign=True)
    return enc


@pytest.mark.parametrize("storage", ["f32", "fp8"])
def test_encoder_matches_jax(jax_side, storage):
    _, params, _, outs = jax_side
    enc = _port(jax.tree.map(np.asarray, params))
    if storage == "fp8":  # the port's own cast of the f32 weights
        enc.load_state_dict(cast_te_params_fp8(enc.state_dict()), assign=True)
        n8 = sum(int(p.dtype == torch.float8_e4m3fn) for p in enc.parameters())
        assert n8 == 2 * 7  # the seven linears of each block
    ids, mask = _inputs()
    with torch.no_grad():
        out = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    ref = outs[storage]
    assert out.shape == ref.shape == (2, 16, 32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_fp8_cast_matches_jax(jax_side):
    _, params, fp8, _ = jax_side
    ours = cast_te_params_fp8(tree_to_state_dict(jax.tree.map(np.asarray, params)))
    ref = tree_to_state_dict(jax.tree.map(np.asarray, fp8))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype, k
        assert torch.equal(ours[k].view(torch.uint8) if v.element_size() == 1 else ours[k],
                           v.view(torch.uint8) if v.element_size() == 1 else v), k


def _comfy(params, cfg):
    """The ComfyUI-layout checkpoint of the JAX parameters."""
    p = params
    sd = {"shared.weight": np.asarray(p["token_embedding"]["embedding"]),
          "encoder.final_layer_norm.weight": np.asarray(p["final_norm"])}
    names = {"attn_q": "layer.0.SelfAttention.q", "attn_k": "layer.0.SelfAttention.k",
             "attn_v": "layer.0.SelfAttention.v", "attn_o": "layer.0.SelfAttention.o",
             "ffn_gate": "layer.1.DenseReluDense.wi_0", "ffn_fc1": "layer.1.DenseReluDense.wi_1",
             "ffn_fc2": "layer.1.DenseReluDense.wo"}
    for i in range(cfg.num_layers):
        b, pre = p[f"block_{i}"], f"encoder.block.{i}"
        for ours, theirs in names.items():
            sd[f"{pre}.{theirs}.weight"] = np.ascontiguousarray(np.asarray(b[ours]["kernel"]).T)
        sd[f"{pre}.layer.0.layer_norm.weight"] = np.asarray(b["norm1"])
        sd[f"{pre}.layer.1.layer_norm.weight"] = np.asarray(b["norm2"])
        sd[f"{pre}.layer.0.SelfAttention.relative_attention_bias.weight"] = np.asarray(
            b["pos_embedding"])
    return sd


def test_convert_umt5_comfy_matches_jax(jax_side):
    cfg, params, _, _ = jax_side
    sd = _comfy(params["params"], cfg)
    ref = tree_to_state_dict(jumt5.convert_umt5_comfy(sd, cfg))
    ours = pumt5.convert_umt5_comfy({k: torch.from_numpy(v) for k, v in sd.items()},
                                    pumt5.UMT5Config.tiny())
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert torch.equal(ours[k], v), k


@pytest.mark.parametrize("qlen", [16, 512])
def test_relative_position_buckets_match(qlen):
    np.testing.assert_array_equal(pumt5.relative_position_buckets(qlen, qlen, 32, 128),
                                  jumt5.relative_position_buckets(qlen, qlen, 32, 128))
