"""The port's AutoencoderKL (models/autoencoder_kl.py) against the JAX one.

The tiny config and a tiny Flux-shaped config (16 latent channels, four
levels: the Flux pipeline's `_tiny` VAE), random weights drawn with numpy on
the JAX parameter structure and mapped by interop.tree_to_state_dict; encode
(the posterior mode, scaled and shifted) and decode of the same f32 input
in both, on the CPU. Tolerance: 2e-5 of the largest output magnitude (f32
convolutions and group norms summed in another order; measured 0.9e-6 to
1.7e-6). convert_diffusers_vae and diffusers_vae_state_dict are inverses
over every parameter.
"""

import jax
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import autoencoder_kl as jvae
from diffusion_pipe_tpu_torch.interop import tree_to_state_dict
from diffusion_pipe_tpu_torch.models import autoencoder_kl as pvae
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE

CONFIGS = {
    "tiny": dict(latent_channels=4, block_out_channels=(8, 16), norm_num_groups=4,
                 layers_per_block=1, scaling_factor=1.0, shift_factor=0.0),
    "flux-shaped": dict(latent_channels=16, block_out_channels=(8, 8, 16, 16),
                        norm_num_groups=4, layers_per_block=1),
}


def _random_params(vae, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(vae.init, jax.random.PRNGKey(0), jax.numpy.zeros((1, 3, 32, 32)))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_and_decode_match_jax(name):
    kw = CONFIGS[name]
    jmodel = jvae.AutoencoderKL(jvae.VAEConfig(**kw))
    params = _random_params(jmodel, seed=3)
    port = pvae.AutoencoderKL(pvae.VAEConfig(**kw))
    port.load_state_dict(tree_to_state_dict(params))

    x = np.random.default_rng(4).uniform(-1, 1, (2, 3, 32, 40)).astype(np.float32)
    encode = jax.jit(lambda p, px: jmodel.apply(p, px, method=type(jmodel).encode),
                     compiler_options=JAX_FAST_COMPILE)
    z_ref = np.array(encode(params, x))
    decode = jax.jit(lambda p, z: jmodel.apply(p, z, method=type(jmodel).decode),
                     compiler_options=JAX_FAST_COMPILE)
    x_ref = np.array(decode(params, z_ref))
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x)).numpy()
        x_out = port.decode(torch.from_numpy(z_ref)).numpy()
    assert z.shape == z_ref.shape == (2, kw["latent_channels"], 32 // port.config.downscale,
                                      40 // port.config.downscale)
    np.testing.assert_allclose(z, z_ref, rtol=0, atol=2e-5 * np.abs(z_ref).max())
    np.testing.assert_allclose(x_out, x_ref, rtol=0, atol=2e-5 * np.abs(x_ref).max())


@pytest.mark.parametrize("name", ["tiny", "flux"])
def test_diffusers_names_round_trip(name):
    cfg = pvae.VAEConfig.tiny() if name == "tiny" else pvae.VAEConfig.flux()
    with torch.device("meta" if name == "flux" else "cpu"):
        vae = pvae.AutoencoderKL(cfg)
    theirs = pvae.diffusers_vae_state_dict(vae)
    assert all(k.startswith(("encoder.", "decoder.")) for k in theirs)
    assert "encoder.mid_block.attentions.0.to_out.0.weight" in theirs
    back = pvae.convert_diffusers_vae(theirs, cfg)
    ours = vae.state_dict()
    assert back.keys() == ours.keys()
    for k, v in ours.items():
        assert back[k].shape == v.shape, k
        if name == "tiny":
            assert torch.equal(back[k], v), k
