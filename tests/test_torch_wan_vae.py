"""The port's Wan 2.1 and 2.2 VAEs (models/wan_vae.py, wan_vae22.py) against
the JAX package's, on the same weights (interop.tree_to_state_dict).

Tiny configs: the 2.1 VAE as the Wan pipeline's `_tiny` hook builds it
(dim 8, z 16 with the latent mean/std, three stages, two time downsamples)
and Wan22VAEConfig.tiny() (dim 8, z 8, patchified, one time downsample).
Weights are seeded numpy draws on the JAX parameter structure, gammas and
biases away from 1 and 0. A 9-frame (1 + 4 + 4) 32 px clip is encoded in
three chunks and the latents decoded one latent frame a chunk, through the
feature caches. f32 tolerances: 1e-4 of the largest magnitude on the
latents and on the video (convolutions summed in another order through
about twenty layers; measured below 2e-6).

The checkpoint converters: the port model's weights written in the
reference layout (wan_vae_state_dict) convert through the JAX
convert_wan_vae / convert_wan22_vae into the port's state dict, bit for
bit, and through the port's own converters too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from diffusion_pipe_tpu.models import wan_vae as jvae
from diffusion_pipe_tpu.models import wan_vae22 as jvae22
from diffusion_pipe_tpu.models import wan_vae_convert as jconv
from diffusion_pipe_tpu_torch.interop import tree_to_state_dict
from diffusion_pipe_tpu_torch.models import wan_vae as pvae
from diffusion_pipe_tpu_torch.models import wan_vae22 as pvae22
from diffusion_pipe_tpu_torch.models import wan_vae_convert as pconv
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE

TINY21 = dict(dim=8, z_dim=16, dim_mult=(1, 2, 4), num_res_blocks=1,
              temperal_downsample=(True, True))
CASES = {  # name: (JAX module, JAX config, port module, port config)
    "wan21": (jvae.WanVideoVAE, jvae.WanVAEConfig(**TINY21), pvae.WanVideoVAE,
              pvae.WanVAEConfig(**TINY21)),
    "wan22": (jvae22.WanVideoVAE22, jvae22.Wan22VAEConfig.tiny(), pvae22.WanVideoVAE22,
              pvae22.Wan22VAEConfig.tiny()),
}
VIDEO = (1, 3, 9, 32, 32)


def _seeded_params(module, seed):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 5, 32, 32)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "gamma":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "bias":
            return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(np.asarray, nn.unbox(jax.tree_util.tree_map_with_path(fill, shapes)))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    jcls, jcfg, pcls, pcfg = CASES[request.param]
    jmod = jcls(jcfg)
    params = _seeded_params(jmod, seed=9)
    video = np.random.default_rng(2).uniform(-1, 1, VIDEO).astype(np.float32)
    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def encode_decode(p, x):  # one compile for both
        z = jmod.apply(p, x, method=jcls.encode)
        return z, jmod.apply(p, z, method=jcls.decode)

    z, out = (np.array(a) for a in encode_decode(params, video))
    port = pcls(pcfg)
    port.load_state_dict(tree_to_state_dict(params))
    return request.param, jcfg, params, video, z, out, port


def test_encode_matches_jax(case):
    _, _, _, video, z, _, port = case
    with torch.no_grad():
        got = port.encode(torch.from_numpy(video)).numpy()
    assert got.shape == z.shape and z.shape[2] == (3 if case[0] == "wan21" else 5)
    np.testing.assert_allclose(got, z, rtol=0, atol=1e-4 * np.abs(z).max())


def test_decode_matches_jax(case):
    _, _, _, _, z, out, port = case
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z)).numpy()
    assert got.shape == out.shape == VIDEO
    np.testing.assert_allclose(got, out, rtol=0, atol=1e-4 * np.abs(out).max())


def test_converter_matches_jax(case):
    name, jcfg, params, _, _, _, port = case
    ref_sd = pconv.wan_vae_state_dict(port)
    jconvert = jconv.convert_wan_vae if name == "wan21" else jvae22.convert_wan22_vae
    via_jax = tree_to_state_dict(jconvert({k: v.numpy() for k, v in ref_sd.items()}, jcfg))
    ours = pconv.convert_layout(ref_sd, port.checkpoint_layout())
    want = port.state_dict()
    assert set(via_jax) == set(ours) == set(want)
    for k, v in want.items():
        assert torch.equal(via_jax[k], v) and torch.equal(ours[k], v), k


def test_reference_checkpoint_loads(case, tmp_path):
    """The reference-layout checkpoint of the seeded weights, written as
    safetensors, loads as load_wan_vae / load_wan22_vae load it (read,
    convert, load_vae_checkpoint): every weight in place, frozen."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.weights import load_state_dict_any

    name, _, _, _, _, _, port = case
    safetensors_io.save_file(pconv.wan_vae_state_dict(port), tmp_path / "vae.safetensors")
    cls, cfg = CASES[name][2:]
    vae = pconv.load_vae_checkpoint(cls, cfg, pconv.convert_layout(
        load_state_dict_any(tmp_path / "vae.safetensors"), port.checkpoint_layout()))
    got = vae.state_dict()
    assert set(got) == set(port.state_dict())
    assert all(torch.equal(got[k], v) for k, v in port.state_dict().items())
    assert not any(p.requires_grad for p in vae.parameters())
