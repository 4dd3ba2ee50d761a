"""The port's global gradient norm and clip against optax.global_norm and
the JAX trainer's clip, eagerly (no jit), on random leaves of mixed sizes.

- bf16 leaves: optax squares in bf16, sums each leaf in f32, rounds each
  leaf's sum to bf16, adds the leaves and takes the root in bf16; the port
  follows it and must land within one bf16 ulp (in practice on the same
  bits). The clipped gradients, scaled in bf16 and rounded to bf16, within
  one bf16 ulp of each element.
- f32 leaves (the GAS > 1 path): the same value as the port's f32 norm
  before (the square root of the f32 sum of f32 leaf sums), bit for bit,
  and optax's within 1e-6 relative (XLA sums in another order).
- mixed bf16 and f32 leaves: an f32 norm, as optax's.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_pipe_tpu_torch.training.trainer import clip_by_global_norm, global_norm
from torch_port_helpers import bf16_ulp

SHAPES = {"w_in": (64, 48), "bias": (48,), "w_out": (7, 33, 5), "scale": (1,)}


def _leaves(dtypes, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for (name, shape), dt in zip(SHAPES.items(), dtypes):
        x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.1, 3.0)
        out[name] = torch.from_numpy(x).to(dt)
    return out


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_global_norm_and_clip_match_optax(seed):
    leaves = _leaves([torch.bfloat16] * len(SHAPES), seed)
    jleaves = {k: _to_jax(v) for k, v in leaves.items()}
    want = optax.global_norm(jleaves)
    got = global_norm(leaves.values())
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    w = float(want)
    assert abs(got.item() - w) <= bf16_ulp(np.float32(w))

    clip = 0.5 * w  # a norm above the limit, so the scale is not 1
    jscale = jnp.minimum(1.0, clip / (want + 1e-6))
    clipped = clip_by_global_norm(list(leaves.values()), got, clip)
    for (name, jg), g in zip(jleaves.items(), clipped):
        jc = np.asarray((jg * jscale).astype(jg.dtype), dtype=np.float32)
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_less(np.abs(g.float().numpy() - jc), bf16_ulp(jc) + 1e-30,
                                     err_msg=name)


def test_f32_global_norm_is_unchanged():
    leaves = list(_leaves([torch.float32] * len(SHAPES)).values())
    before = torch.sqrt(sum(g.float().pow(2).sum() for g in leaves))
    got = global_norm(leaves)
    assert got.dtype == torch.float32 and torch.equal(got, before)
    want = float(optax.global_norm([_to_jax(g) for g in leaves]))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_mixed_dtypes_give_an_f32_norm():
    leaves = _leaves([torch.bfloat16, torch.float32, torch.bfloat16, torch.float32])
    want = optax.global_norm({k: _to_jax(v) for k, v in leaves.items()})
    got = global_norm(leaves.values())
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
