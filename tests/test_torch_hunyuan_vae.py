"""The HunyuanVideo causal 3D VAE in the port vs the JAX package, and its
published form against constructions built here.

The JAX form (interop.hunyuan_vae_config: jax_form, i.e. zero spatial
padding, attention within each frame and the JAX time-upsampling blocks;
no quant convolutions)
at the JAX `tiny` widths (8, 16, 16, 16), one resnet a block, 4 latent
channels, on seeded numpy weights crossed with interop.hunyuan_vae_state_dict:
encode of a 5-frame 32 x 32 clip and decode of 2 latent frames against one
JAX jit, rel L2 1e-4 (f32).

The published form, each departure against an independent construction:
replicate padding against F.pad(mode="replicate") + F.conv3d, exactly; the
frame-causal mid attention against a dense softmax over all (f h w) tokens
under a block-causal additive mask, rel L2 1e-5, and equal to the per-frame
form on frame 0 (1e-6); the frame counts of every up and down block; the
quant convolutions taken from the keys (and absent without them). The key
dialects (diffusers', the original SD-VAE names, causal convolutions without
their inner `.conv`) convert to the same state dict; a missing or an
untaken key raises.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_pipe_tpu.models import hunyuan_vae as jvae
from diffusion_pipe_tpu_torch.interop import hunyuan_vae_config, hunyuan_vae_state_dict
from diffusion_pipe_tpu_torch.models import hunyuan_vae as tvae
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE

CLIP = (1, 3, 5, 32, 32)
LATENTS = (1, 4, 2, 4, 4)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _seeded_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def reference():
    """The JAX tiny VAE, seeded weights, a clip and latents, and the JAX
    encode and decode of them (one jit)."""
    cfg = jvae.HunyuanVAEConfig.tiny()
    vae = jvae.HunyuanVAE(cfg)
    rng = np.random.default_rng(7)
    px = rng.uniform(-1, 1, CLIP).astype(np.float32)
    z = rng.standard_normal(LATENTS).astype(np.float32)
    shapes = jax.eval_shape(vae.init, jax.random.PRNGKey(0), jnp.zeros(CLIP))
    params = _seeded_tree(shapes, 11)

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(p):
        return (vae.apply(p, px, method=type(vae).encode),
                vae.apply(p, z, method=type(vae).decode))

    enc, dec = run(params)
    return dict(cfg=cfg, params=jax.tree.map(np.asarray, params), px=px, z=z,
                enc=np.asarray(enc), dec=np.asarray(dec))


def port_jax_form(ref):
    cfg = hunyuan_vae_config(ref["cfg"])
    vae = tvae.HunyuanVAE(cfg)
    vae.load_state_dict(hunyuan_vae_state_dict(ref["params"]))
    return vae.eval()


@pytest.mark.parametrize("side", ["encode", "decode"])
def test_jax_form_matches_jax(side):
    """The port in the JAX form against the JAX module (rel L2 1e-4)."""
    ref = reference()
    vae = port_jax_form(ref)
    with torch.no_grad():
        if side == "encode":
            got, want = vae.encode(torch.from_numpy(ref["px"])), ref["enc"]
        else:
            got, want = vae.decode(torch.from_numpy(ref["z"])), ref["dec"]
    assert got.shape == want.shape == ((1, 4, 2, 4, 4) if side == "encode" else CLIP)
    assert rel_l2(got.numpy(), want) < 1e-4


def _seeded(cfg, seed=0):
    vae = tvae.HunyuanVAE(cfg)
    vae.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # norms and biases away from 1 and 0
        gen = torch.Generator().manual_seed(seed + 1)
        for n, p in vae.named_parameters():
            if n.endswith("bias") or p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return vae.eval()


TINY = tvae.HunyuanVAEConfig.tiny()


@pytest.mark.parametrize("stride", [(1, 1, 1), (2, 2, 2), (1, 2, 2)])
def test_replicate_padding(stride):
    """A published causal convolution is F.pad(mode="replicate") of (1, 1)
    pixels and (2, 0) frames, then conv3d without padding; the JAX form
    (spatial_padding "zeros", as LTX's VAE pads too) replicates in time and
    pads zeros in space."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 5, 7, 6), generator=gen)
    conv = tvae.CausalConv3d(4, 6, stride=stride)
    jax_form = tvae.CausalConv3d(4, 6, stride=stride, spatial_padding="zeros")
    jax_form.load_state_dict(conv.state_dict())
    w, b = conv.conv.weight, conv.conv.bias
    with torch.no_grad():
        want = F.conv3d(F.pad(x, (1, 1, 1, 1, 2, 0), mode="replicate"), w, b, stride)
        assert torch.equal(conv(x), want)
        t_pad = torch.cat([x[:, :, :1], x[:, :, :1], x], dim=2)
        assert torch.equal(jax_form(x), F.conv3d(t_pad, w, b, stride, padding=(0, 1, 1)))
        assert not torch.allclose(conv(x), jax_form(x))


def test_frame_causal_mid_attention():
    """The published mid attention over the whole clip: a token of frame i
    sees every token of frames <= i (diffusers' prepare_causal_attention_mask,
    built here as a dense additive mask over (f h w) tokens); on frame 0 it
    is the per-frame form."""
    cfg = dataclasses.replace(TINY, block_out_channels=(8, 16, 16, 32))
    att = tvae.MidAttention(cfg, 32)
    per_frame = tvae.MidAttention(dataclasses.replace(cfg, jax_form=True), 32)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in att.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    per_frame.load_state_dict(att.state_dict())
    x = torch.randn((2, 32, 3, 4, 5), generator=gen)
    with torch.no_grad():
        got = att(x)
        b, c, f, h, w = x.shape
        y = att.group_norm(x).permute(0, 2, 3, 4, 1).reshape(b, f * h * w, c)
        q, k, v = att.to_q(y), att.to_k(y), att.to_v(y)
        frame = torch.arange(f).repeat_interleave(h * w)
        bias = torch.where(frame[None, :] <= frame[:, None], 0.0, float("-inf"))
        p = torch.softmax(q @ k.transpose(1, 2) / c ** 0.5 + bias, dim=-1)
        want = x + att.to_out[0](p @ v).reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3)
        assert rel_l2(got.numpy(), want.numpy()) < 1e-5
        first = per_frame(x)
        np.testing.assert_allclose(got[:, :, 0].numpy(), first[:, :, 0].numpy(), atol=1e-6)
        assert rel_l2(got[:, :, 1:].numpy(), first[:, :, 1:].numpy()) > 1e-3


def _frames(blocks, x, run):
    seen = []
    hooks = [b.register_forward_hook(lambda m, i, o: seen.append(o.shape[2])) for b in blocks]
    try:
        with torch.no_grad():
            out = run(x)
    finally:
        for h in hooks:
            h.remove()
    return seen, out


@pytest.mark.parametrize("form", ["published", "jax"])
def test_block_frame_counts(form):
    """9 frames encode to 3 (down blocks 1 and 2 halve them); 3 latent
    frames decode to 9 = 4 (3 - 1) + 1, doubled in up blocks 1 and 2
    (published) or 0 and 1 (the JAX form)."""
    cfg = TINY if form == "published" else dataclasses.replace(TINY, jax_form=True)
    vae = _seeded(cfg)
    down, z = _frames(vae.encoder.down_blocks, torch.randn(1, 3, 9, 16, 16),
                      vae.encode_moments)
    up, out = _frames(vae.decoder.up_blocks, torch.randn(1, 4, 3, 2, 2), vae.decode)
    assert down == [9, 5, 3, 3] and z.shape[2] == 3
    assert up == ([3, 5, 9, 9] if form == "published" else [5, 9, 9, 9])
    assert tuple(out.shape) == (1, 3, 9, 16, 16)


def _diffusers_sd(vae):
    return {k: v.clone() for k, v in vae.state_dict().items()}


def _sd_dialect(sd, n_up=4):
    """diffusers' keys in the original SD-VAE naming (built here, the
    inverse of the renames the loaders apply)."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"down_blocks\.(\d+)\.resnets\.(\d+)\.", r"down.\1.block.\2.", k)
        k = re.sub(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.", r"down.\1.downsample.conv.", k)
        k = re.sub(r"decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.",
                   lambda m: f"decoder.up.{n_up - 1 - int(m.group(1))}.block.{m.group(2)}.", k)
        k = re.sub(r"decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.",
                   lambda m: f"decoder.up.{n_up - 1 - int(m.group(1))}.upsample.conv.", k)
        k = k.replace("mid_block.resnets.0.", "mid.block_1.").replace(
            "mid_block.resnets.1.", "mid.block_2.")
        if "mid_block.attentions.0." in k:
            k = k.replace("mid_block.attentions.0.", "mid.attn_1.")
            for new, old in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj_out", "to_out.0"),
                             ("norm", "group_norm")):
                k = k.replace(f".{old}.", f".{new}.")
            if k.endswith(".weight") and v.dim() == 2:
                v = v.reshape(*v.shape, 1, 1, 1)
        k = k.replace("conv_norm_out.", "norm_out.")
        out[k] = v
    return out


def test_quant_convs_and_dialects():
    """The topology and the quant convolutions come from the keys;
    diffusers' keys, the original names and keys without the inner `.conv`
    convert to the same weights; a missing or an untaken key raises."""
    vae = _seeded(dataclasses.replace(TINY, latent_channels=16))
    sd = _diffusers_sd(vae)
    cfg = tvae.infer_hunyuan_vae_config(sd)
    assert cfg == dataclasses.replace(TINY, latent_channels=16) and cfg.quant_convs
    assert sd["quant_conv.weight"].shape == (32, 32, 1, 1, 1)
    assert sd["post_quant_conv.weight"].shape == (16, 16, 1, 1, 1)
    bare = {k.replace(".conv.weight", ".weight").replace(".conv.bias", ".bias"): v
            for k, v in sd.items()}
    assert "encoder.down_blocks.1.downsamplers.0.conv.weight" in bare
    for variant in (sd, _sd_dialect(sd), bare):
        got = tvae.convert_hunyuan_vae(variant, cfg)
        assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    without = {k: v for k, v in sd.items() if "quant_conv" not in k}
    no_quant = tvae.infer_hunyuan_vae_config(without)
    assert not no_quant.quant_convs
    assert set(tvae.convert_hunyuan_vae(without, no_quant)) == set(without)
    with pytest.raises(KeyError, match="to_k"):
        tvae.convert_hunyuan_vae({k: v for k, v in sd.items()
                                  if k != "decoder.mid_block.attentions.0.to_k.weight"}, cfg)
    with pytest.raises(KeyError, match="extra"):
        tvae.convert_hunyuan_vae({**sd, "encoder.extra.weight": torch.zeros(1)}, cfg)


def test_load_and_encode_decode(tmp_path):
    """load_hunyuan_vae of a diffusers `vae/` folder gives the seeded VAE
    bit for bit; encode scales the posterior mean by 0.476986 and decode
    divides it out."""
    from diffusion_pipe_tpu_torch import safetensors_io

    src = _seeded(dataclasses.replace(TINY, latent_channels=16))
    (tmp_path / "vae").mkdir()
    safetensors_io.save_file(_diffusers_sd(src), str(tmp_path / "vae" / "model.safetensors"))
    vae = tvae.load_hunyuan_vae(tmp_path)
    x = torch.rand((1, 3, 5, 16, 16)) * 2 - 1
    with torch.no_grad():
        z = vae.encode(x)
        moments = src.encode_moments(x)
        assert torch.equal(z, moments[:, :16] * 0.476986)
        assert tuple(z.shape) == (1, 16, 2, 2, 2)
        assert torch.equal(vae.decode(z), src.decode(z))
