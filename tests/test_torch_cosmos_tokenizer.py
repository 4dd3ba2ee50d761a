"""The Cosmos-1 continuous video tokenizer in the port vs the JAX package.

The tiny tokenizer (patch 2, channels 8 x (1, 2), a resnet a level, z and
embedding 4, one hybrid down / upsample in space and time) with the
attention pair after the second level's resnets, so the down / up path's
attention runs as well as the mid blocks'. Seeded numpy weights on the JAX
parameter structure cross through interop.tree_to_state_dict, the
statistics away from 0 and 1. One jit gives the JAX haar patcher and its
inverse, encode of a 9-frame clip and of an image, and decode of the
clip's latents. Tolerances (f32): the haar functions 1e-6, encode and
decode 1e-5 abs / 1e-5 rel.

The converter: the port's key names against the checkpoint's, written out
here; a checkpoint in the bare dialect (Conv3d and GroupNorm without their
wrappers) with a decoder upsample's temporal and spatial convs under each
other's names converts to the same weights; a key no weight takes, and a
key missing, raise; the JAX converter reads what the port writes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import cosmos_tokenizer as jt
from diffusion_pipe_tpu_torch.interop import tree_to_state_dict
from diffusion_pipe_tpu_torch.models import cosmos_tokenizer as pt
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE

OVER = dict(attn_levels=(1,))


@functools.lru_cache(maxsize=None)
def reference():
    jcfg = dataclasses.replace(jt.CosmosTokenizerConfig.tiny(), **OVER)
    tok = jt.CosmosVideoTokenizer(jcfg)
    rng = np.random.default_rng(0)
    clip = rng.uniform(-1, 1, (1, 3, 9, 16, 16)).astype(np.float32)
    image = rng.uniform(-1, 1, (2, 3, 1, 16, 24)).astype(np.float32)
    shapes = jax.eval_shape(tok.init, jax.random.PRNGKey(0), jnp.asarray(clip))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(leaf.shape[:-1])
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "latent_std"):
            return (1.0 + 0.1 * rng.random(leaf.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(params, clip, image):
        z = tok.apply(params, clip, method=type(tok).encode)
        patched = jt.haar_patch_3d(jnp.transpose(clip, (0, 2, 3, 4, 1)), 2)
        return dict(z=z, z_image=tok.apply(params, image, method=type(tok).encode),
                    decoded=tok.apply(params, z, method=type(tok).decode),
                    patched=jnp.transpose(patched, (0, 4, 1, 2, 3)),
                    unpatched=jnp.transpose(jt.haar_unpatch_3d(patched, 2), (0, 4, 1, 2, 3)))

    res = jax.tree.map(np.asarray, run(params, clip, image))
    return dict(jcfg=jcfg, params=jax.tree.map(np.asarray, params), clip=clip, image=image,
                res=res)


def port_tokenizer(ref):
    tok = pt.CosmosVideoTokenizer(pt.CosmosTokenizerConfig.tiny(**OVER))
    tok.load_state_dict(tree_to_state_dict(ref["params"]))
    return tok


def test_haar_matches_jax_and_inverts():
    """The haar patcher (the first frame replicated, 2 levels' bands
    band-major) against the JAX one, and its inverse back to the clip."""
    ref = reference()
    clip = torch.from_numpy(ref["clip"])
    patched = pt.haar_patch_3d(clip, 2)
    assert patched.shape == (1, 24, 5, 8, 8)
    np.testing.assert_allclose(patched.numpy(), ref["res"]["patched"], atol=1e-6)
    back = pt.haar_unpatch_3d(patched, 2)
    np.testing.assert_allclose(back.numpy(), ref["res"]["unpatched"], atol=1e-6)
    np.testing.assert_allclose(back.numpy(), ref["clip"], atol=1e-6)
    four = pt.haar_patch_3d(clip, 4)
    assert four.shape == (1, 192, 3, 4, 4)
    np.testing.assert_allclose(pt.haar_unpatch_3d(four, 4).numpy(), ref["clip"], atol=1e-5)


def test_encode_decode_match_jax():
    """encode of a 9-frame clip (-> 3 latent frames) and of two images, and
    decode of the clip's latents, against the JAX tokenizer."""
    ref = reference()
    tok = port_tokenizer(ref)
    with torch.no_grad():
        z = tok.encode(torch.from_numpy(ref["clip"]))
        z_image = tok.encode(torch.from_numpy(ref["image"]))
        decoded = tok.decode(torch.tensor(ref["res"]["z"]))
    assert z.shape == (1, 4, 3, 4, 4) and z_image.shape == (2, 4, 1, 4, 6)
    np.testing.assert_allclose(z.numpy(), ref["res"]["z"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(z_image.numpy(), ref["res"]["z_image"], atol=1e-5, rtol=1e-5)
    assert decoded.shape == (1, 3, 9, 16, 16)
    np.testing.assert_allclose(decoded.numpy(), ref["res"]["decoded"], atol=1e-5, rtol=1e-5)


# the port's names -> the checkpoint's (the wrapped dialect)
NAMES = {
    "encoder.conv_in.s.conv.weight": "encoder.conv_in.0.conv3d.weight",
    "encoder.conv_in.t.conv.bias": "encoder.conv_in.1.conv3d.bias",
    "encoder.down_0_res_0.norm1.weight": "encoder.down.0.block.0.norm1.norm.weight",
    "encoder.down_0_res_0.conv2.t.conv.weight": "encoder.down.0.block.0.conv2.1.conv3d.weight",
    "encoder.down_1_res_0.nin_shortcut.conv.weight":
        "encoder.down.1.block.0.nin_shortcut.conv3d.weight",
    "encoder.down_1_attn_0_s.q.conv.weight": "encoder.down.1.attn.0.0.q.conv3d.weight",
    "encoder.down_1_attn_0_t.norm.bias": "encoder.down.1.attn.0.1.norm.norm.bias",
    "encoder.down_0_downsample.conv1.conv.weight": "encoder.down.0.downsample.conv1.conv3d.weight",
    "encoder.down_0_downsample.conv2_conv.weight": "encoder.down.0.downsample.conv2.conv3d.weight",
    "encoder.down_0_downsample.conv3.conv.bias": "encoder.down.0.downsample.conv3.conv3d.bias",
    "encoder.mid_res_0.norm2.bias": "encoder.mid.block_1.norm2.norm.bias",
    "encoder.mid_res_1.conv1.s.conv.weight": "encoder.mid.block_2.conv1.0.conv3d.weight",
    "encoder.mid_attn_s.proj_out.conv.weight": "encoder.mid.attn_1.0.proj_out.conv3d.weight",
    "encoder.mid_attn_t.k.conv.bias": "encoder.mid.attn_1.1.k.conv3d.bias",
    "encoder.norm_out.weight": "encoder.norm_out.norm.weight",
    "decoder.up_1_res_1.conv1.s.conv.weight": "decoder.up.1.block.1.conv1.0.conv3d.weight",
    "decoder.up_1_attn_1_t.v.conv.weight": "decoder.up.1.attn.1.1.v.conv3d.weight",
    "decoder.up_1_upsample.conv1.conv.weight": "decoder.up.1.upsample.conv1.conv3d.weight",
    "decoder.up_1_upsample.conv2.conv.weight": "decoder.up.1.upsample.conv2.conv3d.weight",
    "quant_conv.conv.weight": "quant_conv.conv3d.weight",
    "post_quant_conv.conv.bias": "post_quant_conv.conv3d.bias",
    "latent_mean": "latent_mean",
}


def _bare(name):
    return name.replace(".conv3d.", ".").replace(".norm.weight", ".weight").replace(
        ".norm.bias", ".bias")


def test_converter_reads_the_checkpoint_names():
    """The names above both ways; the wrapped and the bare dialect (the
    upsample's convs under each other's names) convert to the same weights
    and config; the JAX converter reads what the port writes; a key no
    weight takes and a key missing raise, naming it."""
    ref = reference()
    tok = port_tokenizer(ref)
    for ours, theirs in NAMES.items():
        assert pt.checkpoint_name(ours) == theirs
    ck = pt.tokenizer_checkpoint(tok)
    assert set(NAMES.values()) <= set(ck)
    cfg, sd = pt.convert_cosmos_tokenizer(ck)
    assert cfg == tok.cfg
    state = tok.state_dict()
    assert set(sd) == set(state) and all(torch.equal(sd[k], state[k]) for k in sd)
    swap = {"decoder.up.1.upsample.conv1": "decoder.up.1.upsample.conv2",
            "decoder.up.1.upsample.conv2": "decoder.up.1.upsample.conv1"}
    bare = {}
    for k, v in ck.items():
        for a, b in swap.items():
            if k.startswith(a + "."):
                k = b + k[len(a):]
                break
        bare[_bare(k)] = v
    bare["encoder.patcher.wavelets"] = torch.ones(2)
    cfg2, sd2 = pt.convert_cosmos_tokenizer(bare)
    assert cfg2 == cfg and all(torch.equal(sd2[k], state[k]) for k in sd)
    assert bare["decoder.up.1.upsample.conv2.weight"].shape[2:] == (3, 1, 1)
    jcfg, jparams = jt.convert_cosmos_tokenizer({k: v.numpy() for k, v in ck.items()})
    assert jcfg == ref["jcfg"]
    jsd = tree_to_state_dict(jparams)
    assert set(jsd) == set(state) and all(torch.equal(jsd[k], state[k]) for k in jsd)
    with pytest.raises(KeyError, match=r"encoder\.down\.0\.block\.0\.conv1\.2"):
        pt.convert_cosmos_tokenizer({**ck, "encoder.down.0.block.0.conv1.2.conv3d.weight":
                                     torch.zeros(1)})
    with pytest.raises(KeyError, match=r"encoder\.mid\.attn_1\.1\.q"):
        pt.convert_cosmos_tokenizer({k: v for k, v in ck.items()
                                     if not k.startswith("encoder.mid.attn_1.1.q.")})


def test_published_layout():
    """The published CV8x8x8 layout: 192 patched channels, widths 256 / 512
    / 512, 8x in space and time; its checkpoint's layout reads back."""
    cfg = pt.CosmosTokenizerConfig()
    with torch.device("meta"):
        tok = pt.CosmosVideoTokenizer(cfg)
    ck = {pt.checkpoint_name(k): v for k, v in tok.state_dict().items()}
    assert ck["encoder.conv_in.0.conv3d.weight"].shape == (128, 192, 1, 3, 3)
    assert ck["encoder.down.0.downsample.conv2.conv3d.weight"].shape == (256, 256, 3, 1, 1)
    assert "encoder.down.1.downsample.conv1.conv3d.weight" not in ck
    assert pt.tokenizer_layout(ck) == cfg
