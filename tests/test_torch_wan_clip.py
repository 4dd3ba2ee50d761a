"""The port's CLIP vision tower (models/wan_clip.py) against the JAX
package's, on the same weights (interop.tree_to_state_dict).

Tiny config (28 px, patch 14: 4 patches + the class token, dim 32, 4 heads,
the first of 2 blocks run), two 40 x 48 frames in [-1, 1], resized to 28 px
(bicubic, antialiased). f32: the tokens agree within 1e-5 of their largest
magnitude. resize_weights / resize_images against jax.image.resize
(bicubic and linear, down and up): within 1e-6 (f32 sums in another
order). convert_wan_clip_visual of the same visual.* checkpoint gives the
same state dict in both packages, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from diffusion_pipe_tpu.models import wan_clip as jclip
from diffusion_pipe_tpu_torch.interop import tree_to_state_dict
from diffusion_pipe_tpu_torch.models import wan_clip as pclip
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE

PIXELS = (2, 3, 40, 48)


@pytest.fixture(scope="module")
def jax_side():
    cfg = jclip.WanClipVisionConfig.tiny()
    mod = jclip.WanClipVision(cfg)
    pixels = np.random.default_rng(4).uniform(-1, 1, PIXELS).astype(np.float32)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), pixels)
    rng = np.random.default_rng(6)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "bias":
            return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if name == "kernel" else leaf.shape[-1]
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree.map(np.asarray, nn.unbox(jax.tree_util.tree_map_with_path(fill, shapes)))
    out = np.asarray(jax.jit(mod.apply, compiler_options=JAX_FAST_COMPILE)(params, pixels))
    return cfg, params, pixels, out


def test_tower_matches_jax(jax_side):
    _, params, pixels, ref = jax_side
    port = pclip.WanClipVision(pclip.WanClipVisionConfig.tiny())
    port.load_state_dict(tree_to_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(pixels)).numpy()
    assert got.shape == ref.shape == (2, 5, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("method,size", [("bicubic", (28, 20)), ("bicubic", (64, 72)),
                                         ("linear", (16, 16)), ("linear", (50, 33))])
def test_resize_matches_jax_image_resize(method, size):
    x = np.random.default_rng(1).uniform(-1, 1, PIXELS).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), PIXELS[:2] + size, method))
    got = pclip.resize_images(torch.from_numpy(x), size, method).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_convert_matches_jax(jax_side):
    cfg, params, _, _ = jax_side
    port = pclip.WanClipVision(pclip.WanClipVisionConfig.tiny())
    port.load_state_dict(tree_to_state_dict(params))
    names = {"norm1": "norm1", "to_qkv": "attn.to_qkv", "proj": "attn.proj",
             "norm2": "norm2", "mlp_fc1": "mlp.0", "mlp_fc2": "mlp.2"}
    sd = {}
    for k, v in port.state_dict().items():
        if k.startswith("blocks."):
            _, i, mod, leaf = k.split(".")
            k = f"transformer.{i}.{names[mod]}.{leaf}"
        sd[f"visual.{k}"] = v
    ref = tree_to_state_dict(jclip.convert_wan_clip_visual({k: v.numpy() for k, v in sd.items()},
                                                           cfg))
    ours = pclip.convert_wan_clip_visual(sd, pclip.WanClipVisionConfig.tiny())
    assert set(ours) == set(ref) == set(port.state_dict())
    for k, v in ref.items():
        assert torch.equal(ours[k], v), k
