"""Port layers vs the JAX package's layers on the same numpy inputs.

Weights come from the Flax init and cross over through interop.py; every
comparison is in f32 on the CPU with atol/rtol 1e-5 (the two frameworks
differ only in summation order). The JAX side runs under jit with
JAX_FAST_COMPILE (op by op, each op would compile on its own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from diffusion_pipe_tpu.models import layers as jl
from diffusion_pipe_tpu.models import wan_model as jwan
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import layers as tl
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(3)


def _jit(fn, **kw):
    return jax.jit(fn, compiler_options=JAX_FAST_COMPILE, **kw)


def _np(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("rank", [0, 4])
def test_lora_dense(rank):
    """Includes the stored-A convention: A is stored unshifted and both
    packages subtract sqrt(6/in) in the forward; B is set nonzero so the
    LoRA branch contributes."""
    x = _np((2, 5, 24))
    jm = jl.LoraDense(16, dtype=jnp.float32, param_dtype=jnp.float32,
                      lora_rank=rank, lora_alpha=8.0)
    params = jax.tree.map(np.asarray, nn.unbox(_jit(jm.init)(jax.random.PRNGKey(0), x)))
    if rank:
        params["params"]["lora_b"] = _np((rank, 16))
        assert params["params"]["lora_a"].min() >= 0.0  # stored unshifted
    tm = tl.LoraDense(24, 16, dtype=torch.float32, lora_rank=rank, lora_alpha=8.0)
    tm.load_state_dict(jax_to_state_dict(params))
    _close(tm(torch.from_numpy(x)), _jit(jm.apply)(params, x))


def test_rmsnorm_and_layer_norm_and_modulate():
    x = _np((2, 7, 3, 32), 3.0)
    jm = jl.RMSNorm(dtype=jnp.float32, param_dtype=jnp.float32)
    params = {"params": {"scale": _np((32,))}}
    tm = tl.RMSNorm(32)
    tm.load_state_dict(jax_to_state_dict(params))
    y = _np((2, 7, 32), 2.0) + 1.5
    w, b = _np((32,)), _np((32,))  # Wan's affine f32 layer norm
    shift, scale = _np((2, 32)), _np((2, 32))
    ref = _jit(lambda x, y, w, b, shift, scale: (
        jm.apply(params, x), jl.layer_norm_no_affine(y), jwan._layer_norm(y, 1e-6, w, b),
        jl.modulate(y, shift, scale)))(x, y, w, b, shift, scale)
    _close(tm(torch.from_numpy(x)), ref[0])
    _close(tl.layer_norm(torch.from_numpy(y)), ref[1])
    _close(tl.layer_norm(torch.from_numpy(y), 1e-6, torch.from_numpy(w), torch.from_numpy(b)),
           ref[2])
    _close(tl.modulate(*(torch.from_numpy(a) for a in (y, shift, scale))), ref[3])


def test_timestep_embeddings():
    """atol 1e-4 here: at t ~ 1000 one f32 ulp of the sinusoid's argument is
    6e-5, so the two frameworks' exp/sin may differ by that much."""
    t = np.array([0.0, 137.5, 999.0], np.float32)
    np.testing.assert_allclose(
        tl.sinusoidal_timestep_embedding(torch.from_numpy(t), 256).numpy(),
        np.asarray(_jit(jl.sinusoidal_timestep_embedding, static_argnums=1)(t, 256)),
        atol=1e-4, rtol=0)
    t = t / 1000.0  # small arguments keep the embedders within 1e-5

    for jcls, tcls, x in (
        (lambda: jl.TimestepEmbedder(64, dtype=jnp.float32),
         lambda: tl.TimestepEmbedder(64, dtype=torch.float32), t),
        (lambda: jl.PixArtAlphaTextProjection(64, dtype=jnp.float32),
         lambda: tl.PixArtAlphaTextProjection(32, 64, dtype=torch.float32),
         _np((3, 32))),
    ):
        jm = jcls()
        params = jax.tree.map(np.asarray, _jit(jm.init)(jax.random.PRNGKey(1), x))
        tm = tcls()
        tm.load_state_dict(jax_to_state_dict(params))
        _close(tm(torch.from_numpy(x)), _jit(jm.apply)(params, x))


def test_patch_embedding():
    """Wan's Conv3d patch embedding (kernel = stride = (1, 2, 2)) against the
    Flax Conv on channels-last input; its kernel crosses over through
    interop.py's 5-D transpose."""
    x = _np((2, 16, 3, 6, 8))  # [B, C, F, H, W]
    jm = nn.Conv(24, kernel_size=(1, 2, 2), strides=(1, 2, 2), padding="VALID",
                 dtype=jnp.float32, param_dtype=jnp.float32)
    xl = np.transpose(x, (0, 2, 3, 4, 1))
    params = {"params": {"kernel": _np((1, 2, 2, 16, 24), 0.25), "bias": _np((24,))}}
    tm = tl.PatchEmbed3d(16, 24, (1, 2, 2), dtype=torch.float32)
    tm.load_state_dict(jax_to_state_dict(params))
    _close(tm(torch.from_numpy(x)), np.asarray(jm.apply(params, xl)).reshape(2, -1, 24))


def test_rope():
    ids = np.stack([np.zeros(12), np.arange(12) // 4, np.arange(12) % 4], -1)
    ids = ids.astype(np.float32)
    axes = (8, 12, 12)
    x = _np((2, 12, 3, 32))

    @_jit
    def ref(ids, x):
        jcos, jsin = jl.rope_frequencies(ids, axes)
        return jcos, jsin, jl.apply_rope(x, jcos, jsin)

    jcos, jsin, jrot = ref(ids, x)
    tcos, tsin = tl.rope_frequencies(torch.from_numpy(ids), axes)
    _close(tcos, jcos)
    _close(tsin, jsin)
    _close(tl.apply_rope(torch.from_numpy(x), tcos, tsin), jrot)


def test_interop_splits_stacks_and_keeps_bf16():
    import ml_dtypes

    tree = {"params": {
        "double_blocks": {"ff_in": {"kernel": np.arange(24, dtype=np.float32).reshape(2, 3, 4)}},
        "proj_out": {"kernel": np.ones((3, 5), ml_dtypes.bfloat16)},
    }}
    sd = jax_to_state_dict(tree)
    assert set(sd) == {"double_blocks.0.ff_in.weight", "double_blocks.1.ff_in.weight",
                       "proj_out.weight"}
    np.testing.assert_array_equal(sd["double_blocks.1.ff_in.weight"].numpy(),
                                  tree["params"]["double_blocks"]["ff_in"]["kernel"][1].T)
    assert sd["proj_out.weight"].dtype == torch.bfloat16
    assert tuple(sd["proj_out.weight"].shape) == (5, 3)


def test_remat_spec():
    assert tl.remat_spec({}) == ""
    assert tl.remat_spec({"activation_checkpointing": True}) == "full"
    assert tl.remat_spec({"activation_checkpointing": "attn"}) == "attn"
    assert tl.remat_spec({"activation_checkpointing": True, "remat_policy": "attn"}) == "attn"
    for spec in ("offload_attn", "dots", "unsloth", "offload_dots"):
        assert tl.remat_spec({"activation_checkpointing": spec}) == spec
    with pytest.raises(ValueError):
        tl.remat_spec({"activation_checkpointing": "everything"})
