"""The LTX-Video causal VAE in the port vs the JAX package, and its published
form against constructions built here.

The JAX form (interop.ltx_vae_config: jax_form, i.e. the (ph, pw, c) patch
order, 2 x latent moments, no norm3) at the JAX `tiny` widths (patch 2,
blocks 8 / 16 / 16 / 16, one resnet each, 16 latent channels) on seeded
numpy weights crossed with interop.ltx_vae_state_dict: the encode of a
9-frame 32 x 32 clip (the normalised posterior mean, non-trivial
statistics) and the decode of 2 latent frames against one JAX jit, rel L2
1e-4 (f32).

The published form, each departure against an independent construction:
D4 the patch order against diffusers' permute (0, 1, 3, 7, 5, 2, 4, 6),
exactly; D5 the moments of a 17-row conv_out (16 latent channels) against
the conv_out output read by hand, its last row repeated as every channel's
log-variance, exactly; D6 the channel-change resnet's shortcut against
nn.LayerNorm over the channels then F.conv3d with the 1 x 1 x 1 kernel
(rel 1e-6); the zero spatial padding against a replicated first frame and
F.conv3d(padding=(0, 1, 1)), exactly. The converter: a Lightricks
checkpoint of the published encoder (with a decoder and unused statistics
beside it, under `vae.`) gives the config and the tensors back bit for
bit, diffusers' `conv_shortcut.conv.weight` too; a checkpoint without
norm3, or with a key the model does not take, raises.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_pipe_tpu.models import ltx_vae as jvae
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import ltx_vae_config, ltx_vae_state_dict
from diffusion_pipe_tpu_torch.models import ltx_vae as tvae
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE

CLIP = (1, 3, 9, 32, 32)
LATENTS = (1, 16, 2, 2, 2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@functools.lru_cache(maxsize=None)
def reference():
    """The JAX tiny VAE, seeded weights (statistics away from 0 and 1), a
    clip and latents, and the JAX encode and decode of them (one jit)."""
    cfg = jvae.LTXVAEConfig.tiny()
    vae = jvae.LTXVideoVAE(cfg)
    rng = np.random.default_rng(9)
    px = rng.uniform(-1, 1, CLIP).astype(np.float32)
    z = rng.standard_normal(LATENTS).astype(np.float32)
    shapes = jax.eval_shape(vae.init, jax.random.PRNGKey(0), jnp.zeros(CLIP))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "latents_std":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(p):
        return (vae.apply(p, px, method=type(vae).encode),
                vae.apply(p, z, method=type(vae).decode))

    enc, dec = run(params)
    return dict(cfg=cfg, params=jax.tree.map(np.asarray, params), px=px, z=z,
                enc=np.asarray(enc), dec=np.asarray(dec))


@pytest.mark.parametrize("side", ["encode", "decode"])
def test_jax_form_matches_jax(side):
    """The port in the JAX form against the JAX module (rel L2 1e-4)."""
    ref = reference()
    cfg = ltx_vae_config(ref["cfg"])
    vae = tvae.LTXVideoVAE(cfg)
    vae.load_state_dict(ltx_vae_state_dict(ref["params"], cfg))
    with torch.no_grad():
        if side == "encode":
            got, want = vae.eval().encode(torch.from_numpy(ref["px"])), ref["enc"]
        else:
            got, want = vae.eval().decode(torch.from_numpy(ref["z"])), ref["dec"]
    assert got.shape == want.shape == (LATENTS if side == "encode" else CLIP)
    assert rel_l2(got.numpy(), want) < 1e-4


def test_d4_patch_order_is_lightricks():
    """patchify's channels are (c, pw, ph), diffusers' permute of Lightricks'
    rearrange; unpatchify inverts it; the JAX form's are (ph, pw, c)."""
    x = torch.randn(2, 3, 2, 8, 12)
    p = 4
    want = x.reshape(2, 3, 2, 1, 2, p, 3, p).permute(0, 1, 3, 7, 5, 2, 4, 6).reshape(
        2, 3 * p * p, 2, 2, 3)
    got = tvae.patchify(x, p)
    assert torch.equal(got, want)
    assert torch.equal(tvae.unpatchify(got, p, 3), x)
    jax_order = x.reshape(2, 3, 2, 2, p, 3, p).permute(0, 4, 6, 1, 2, 3, 5).reshape(want.shape)
    assert torch.equal(tvae.patchify(x, p, jax_form=True), jax_order)
    assert torch.equal(tvae.unpatchify(jax_order, p, 3, jax_form=True), x)


def _seeded(cfg, seed=0):
    vae = tvae.LTXVideoVAE(cfg)
    vae.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed + 1)
        for n, p in vae.named_parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return vae.eval()


TINY = tvae.LTXVAEConfig.tiny()


def test_d5_uniform_log_variance():
    """The published conv_out emits latent + 1 rows: the mean is the first
    16, the log-variance the 17th repeated over the 16 channels; encode
    normalises the mean by the statistics."""
    vae = _seeded(TINY)
    assert vae.encoder.conv_out.conv.weight.shape[0] == 17
    x = torch.rand(CLIP) * 2 - 1
    with torch.no_grad():
        out = vae.encoder(x)
        mean, logvar = vae.moments(x)
        z = vae.encode(x)
    assert out.shape == (1, 17, 2, 2, 2)
    assert torch.equal(mean, out[:, :16])
    assert torch.equal(logvar, out[:, 16:17].repeat(1, 16, 1, 1, 1))
    want = (out[:, :16] - vae.latents_mean.reshape(1, -1, 1, 1, 1)) / vae.latents_std.reshape(
        1, -1, 1, 1, 1)
    torch.testing.assert_close(z, want, rtol=0, atol=0)


def test_d6_norm3_before_the_shortcut():
    """The channel-change resnet: h + conv_shortcut(norm3(x)), norm3 an affine
    LayerNorm over the input channels (eps 1e-6)."""
    block = tvae.ResnetBlock3D(8, 16)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x = torch.randn(1, 8, 3, 4, 4, generator=gen)
    ln = torch.nn.LayerNorm(8, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(block.norm3.weight)
        ln.bias.copy_(block.norm3.bias)
        h = block.conv2(F.silu(tvae.pixel_norm(block.conv1(F.silu(tvae.pixel_norm(x))))))
        short = F.conv3d(ln(x.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3),
                         block.conv_shortcut.weight, block.conv_shortcut.bias)
        got = block(x)
    assert rel_l2(got.numpy(), (h + short).numpy()) < 1e-6
    assert tvae.ResnetBlock3D(8, 16, norm3=False).norm3 is None
    assert tvae.ResnetBlock3D(8, 8).norm3 is None


def test_spatial_padding_is_zeros():
    """The causal convolution: the first frame twice in front, zeros in
    space, stride (2, 2, 2) as the compressions run."""
    conv = tvae._conv(4, 6, stride=(2, 2, 2))
    x = torch.randn(1, 4, 5, 6, 6)
    front = torch.cat([x[:, :, :1], x[:, :, :1], x], dim=2)
    want = F.conv3d(front, conv.conv.weight, conv.conv.bias, stride=2, padding=(0, 1, 1))
    with torch.no_grad():
        assert torch.equal(conv(x), want)


def test_converter_reads_a_lightricks_checkpoint(tmp_path):
    """A published encoder written in Lightricks' layout (`vae.` prefix, a
    decoder and the unused statistics beside it) converts to the same config
    and tensors; diffusers' conv_shortcut.conv.weight dialect too; the
    topology of the 0.9.0 widths is read from keys alone; no norm3, or an
    untaken key, raises."""
    src = _seeded(TINY, seed=4)
    ckpt = tvae.ltx_vae_state_dict_for_checkpoint(src)
    extra = {"decoder.conv_in.conv.weight": torch.zeros(1),
             "per_channel_statistics.channel": torch.arange(16.0),
             "per_channel_statistics.mean-of-stds": torch.ones(16)}
    sd = {"vae." + k: v for k, v in {**ckpt, **extra}.items()}
    cfg, got = tvae.convert_ltx_vae(sd)
    assert cfg == dataclasses.replace(TINY)
    for k, v in got.items():
        assert torch.equal(v, src.state_dict()[k]), k
    path = tmp_path / "ltx.safetensors"
    safetensors_io.save_file(sd, str(path))
    loaded = tvae.load_ltx_vae(path)
    x = torch.rand(CLIP) * 2 - 1
    with torch.no_grad():
        assert torch.equal(loaded.encode(x), src.encode(x))
    diffusers = {k.replace("conv_shortcut.", "conv_shortcut.conv."): v for k, v in ckpt.items()}
    assert set(tvae.convert_ltx_vae(diffusers)[1]) == set(got)
    with torch.device("meta"):
        big = tvae.LTXVideoVAE(tvae.LTXVAEConfig())
    assert tvae.infer_ltx_vae_config(
        {k: v for k, v in tvae.ltx_vae_state_dict_for_checkpoint(big).items()}) == (
        tvae.LTXVAEConfig())
    with pytest.raises(KeyError, match="norm3"):
        tvae.convert_ltx_vae({k: v for k, v in ckpt.items() if "norm3" not in k})
    with pytest.raises(KeyError, match="does not take"):
        tvae.convert_ltx_vae({**ckpt, "encoder.down_blocks.0.extra.weight": torch.zeros(1)})
