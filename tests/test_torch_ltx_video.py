"""LTX-Video in the port vs the JAX package, and its published blocks
against a construction written here.

The `_tiny` config (2 blocks, 48 wide in 4 heads of 12, 16 latent channels,
caption 32, f32) with LoRA rank 4, LoRA B nonzero, on seeded numpy weights
crossed with interop.ltx_video_state_dict; the port in the JAX form
(interop.ltx_video_config: LayerNorm pre-norms, a normalised
cross-attention input). The batch: latents of 2 x 4 x 4 (32 tokens), 8 T5
rows of which 5 and 3 are valid, a loss mask.

One jit holds the JAX side: the noise and t its prepare_inputs draws (the
key split in three), its inputs and mean-normalised loss mask with
first_frame_conditioning_p 0 and 1, the module's output, loss and LoRA
gradients at p 0; the first block fed a [B, 1, 6 D] and a per-token [B, S,
6 D] timestep_6d (the latter built here: the JAX adaLN-single's linears at
t and at t = 0 on the first frame's tokens, D3); the RoPE tables at the
pipeline's coordinates at dims 48 and 64 (two identity pairs in front) and
the full-dim rotation. The cross-attention runs on the key mask in the
port and on the JAX module's -10000 bias: they agree because every row
has a valid key. Tolerances (f32): rel L2 1e-4 on outputs and blocks, RoPE
1e-6 abs, loss 1e-5 relative, gradients 1e-4 abs / 1e-3 rel.

D1 and D2: the port's published block (RMS pre-norms, the raw stream into
attn2) against the same block written out here in plain torch (SDPA with a
boolean mask), rel L2 1e-5. The keymap: the JAX keymap_from_flax's names,
a single file (`model.diffusion_model.` with `vae.*` beside) loading bit
for bit, a missing and an untaken key raising, the LoRA export with the
JAX export's keys and tensors and its re-import, a layout from the keys.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models import keymaps as jkm
from diffusion_pipe_tpu.models import ltx_video as jltx
from diffusion_pipe_tpu.models.layers import sinusoidal_timestep_embedding as jax_sinusoidal
from diffusion_pipe_tpu.training.flow import sample_timesteps as jax_sample_timesteps
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import ltx_video_config, ltx_video_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models import ltx_video as tltx
from diffusion_pipe_tpu_torch.models.layers import init_module_weights
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, random_params

KEY = jax.random.PRNGKey(20)
CFG = {"save_every_n_epochs": 1,
       "model": {"type": "ltx-video", "dtype": "float32", "_tiny": True},
       "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
       "optimizer": {"type": "adamw", "lr": 1e-3}}
FHW = (2, 4, 4)
S = 32


def ltx_batch(seed=44):
    rng = np.random.default_rng(seed)
    mask = np.zeros((2, 8), np.int32)
    mask[0, :5], mask[1, :3] = 1, 1
    return {"latents": (rng.standard_normal((2, 16, *FHW)) * 0.5).astype(np.float32),
            "prompt_embeds": rng.standard_normal((2, 8, 32)).astype(np.float32),
            "prompt_attention_mask": mask,
            "mask": (rng.random((2, 12, 20)) > 0.4).astype(np.float32)}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _with_p(p):
    return dict(CFG, model=dict(CFG["model"], first_frame_conditioning_p=p))


@functools.lru_cache(maxsize=None)
def reference():
    """The JAX pipelines (p 0 and 1), weights, batch and results (one jit)."""
    jpipe, jpipe1 = (jax_model_class("ltx-video")(_with_p(p)) for p in (0.0, 1.0))
    params = random_params(jpipe, seed=16, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    batch = ltx_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = jpipe.ltx_config
    rng = np.random.default_rng(4)
    x_blk = rng.standard_normal((2, S, cfg.hidden_size)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, cfg.hidden_size)).astype(np.float32)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)

    def loss(tr, fr, mi, target, lmask):
        out = jpipe.model.apply(merge_params(tr, fr), **mi)
        return jpipe.loss_fn(out, target, lmask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(tr, fr):
        t_key, n_key, _ = jax.random.split(KEY, 3)
        t = jax_sample_timesteps(t_key, 2, jpipe.tdist, image_seq_len=16)
        noise = jax.random.normal(n_key, (2, 16, *FHW), jnp.float32)
        mi, target, lmask = jpipe.prepare_inputs(KEY, jbatch)
        mi1, _, lmask1 = jpipe1.prepare_inputs(KEY, jbatch)
        (l, out), grads = jax.value_and_grad(loss, has_aux=True)(tr, fr, mi, target, lmask)
        p = merge_params(tr, fr)["params"]

        def dense(name, v):
            return v @ p[name]["kernel"] + p[name]["bias"]

        def t6_of(tt):
            emb = jax_sinusoidal(tt * 1000.0, 256)
            e = dense("adaln_linear_2", jax.nn.silu(dense("adaln_linear_1", emb)))
            return dense("adaln_proj", jax.nn.silu(e))

        first = (jnp.arange(S) < FHW[1] * FHW[2])[None, :, None]
        t6_tok = jnp.where(first, t6_of(jnp.zeros((2,)))[:, None], t6_of(t)[:, None])
        bias = ((1.0 - jbatch["prompt_attention_mask"]) * -10000.0)[:, None]
        coords = jnp.transpose(mi["fractional_coords"][0], (1, 0))
        cos, sin = jltx.ltx_rope_tables(coords, cfg.hidden_size, cfg.rope_theta,
                                        cfg.rope_max_pos)
        cos64, sin64 = jltx.ltx_rope_tables(coords, 64, cfg.rope_theta, cfg.rope_max_pos)
        block = jltx.LTXBlock(cfg)
        p0 = {"params": jax.tree.map(lambda a: a[0], p["blocks"])}
        blk, _ = block.apply(p0, x_blk, t6_of(t)[:, None], ctx, bias, cos, sin)
        blk_tok, _ = block.apply(p0, x_blk, t6_tok, ctx, bias, cos, sin)
        return dict(loss=l, out=out, grads=grads, t=t, noise=noise, x=mi["x"], t_in=mi["t"],
                    coords=mi["fractional_coords"], target=target, lmask=lmask, x1=mi1["x"],
                    lmask1=lmask1, block=blk, block_tok=blk_tok, cos=cos, sin=sin, cos64=cos64,
                    sin64=sin64, rope_q=jltx.apply_rope_full_dim(q, cos64, sin64))

    res = jax.tree.map(np.asarray, run(trainable, frozen))
    return dict(jpipe=jpipe, params=jax.tree.map(np.asarray, params), trainable=trainable,
                batch=batch, res=res, x_blk=x_blk, ctx=ctx, q=q)


def port_pipeline(ref, p=0.0):
    pipe = get_model_class("ltx-video")(_with_p(p), device="cpu")
    want = ltx_video_config(ref["jpipe"].ltx_config)
    assert pipe.ltx_config == dataclasses.replace(want, jax_form=False)
    pipe.ltx_config = want
    pipe.model = tltx.LTXTransformer(want)
    pipe.model.load_state_dict(ltx_video_state_dict(ref["params"]))
    return pipe


def _inputs(ref, p=0.0, pipe=None):
    pipe = pipe or port_pipeline(ref, p)
    res = ref["res"]
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    first = torch.ones(2, dtype=torch.bool) if p else None
    return pipe, pipe.prepare_inputs(batch, noise=torch.tensor(res["noise"]),
                                     t=torch.tensor(res["t"]), first_frame=first)


def test_config_is_the_jax_tiny_and_published_defaults():
    """The port's `_tiny` config is the JAX one through interop (published
    blocks aside); the published defaults: 28 blocks of 2,048 in 32 heads of
    64, 128 latent channels, T5 4,096, 1.9 B parameters."""
    pipe = get_model_class("ltx_video")({"model": {"type": "ltx_video"}}, device="cpu")
    c = pipe.ltx_config
    assert (c.num_layers, c.hidden_size, c.num_heads, c.head_dim, c.in_channels,
            c.caption_dim, c.jax_form) == (28, 2048, 32, 64, 128, 4096, False)
    n = sum(p.numel() for p in pipe.model.parameters())
    assert round(n / 1e9, 1) == 1.9, n


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_prepare_inputs_matches(p):
    """Tokens, target, coordinates and the mean-normalised loss mask from the
    JAX noise and t; at p = 1 the first frame is the clean latents and out of
    the loss, as in JAX, and t goes per token, 0 on its 16 tokens (D3)."""
    ref = reference()
    _, (inputs, target, lmask) = _inputs(ref, p)
    res = ref["res"]
    np.testing.assert_allclose(inputs["x"].numpy(), res["x1" if p else "x"], atol=1e-6)
    np.testing.assert_allclose(target.numpy(), res["target"], atol=1e-6)
    np.testing.assert_allclose(lmask.numpy(), res["lmask1" if p else "lmask"], rtol=1e-6)
    np.testing.assert_array_equal(inputs["fractional_coords"].numpy(), res["coords"])
    if p:
        want = np.where(np.arange(S)[None] < 16, 0.0, res["t"][:, None])
        np.testing.assert_array_equal(inputs["t"].numpy(), want)
        assert float(lmask[:, :16].abs().sum()) == 0.0
    else:
        np.testing.assert_array_equal(inputs["t"].numpy(), res["t_in"])


def test_rope_tables_and_rotation_match():
    """ltx_rope_tables at the pipeline's coordinates (dim 48; dim 64 with two
    identity pairs in front) and apply_rope_full_dim against the JAX
    functions (1e-6 abs)."""
    ref = reference()
    res = ref["res"]
    coords = torch.tensor(res["coords"][0]).transpose(0, 1)
    for dim, (c, s) in ((48, ("cos", "sin")), (64, ("cos64", "sin64"))):
        cos, sin = tltx.ltx_rope_tables(coords, dim, 10000.0, (20, 2048, 2048))
        np.testing.assert_allclose(cos.numpy(), res[c], atol=1e-6)
        np.testing.assert_allclose(sin.numpy(), res[s], atol=1e-6)
    assert np.all(res["cos64"][:, :2] == 1.0) and np.all(res["sin64"][:, :2] == 0.0)
    got = tltx.apply_rope_full_dim(torch.from_numpy(ref["q"]), torch.tensor(res["cos64"]),
                                   torch.tensor(res["sin64"]))
    np.testing.assert_allclose(got.numpy(), res["rope_q"], atol=1e-6)


@pytest.mark.parametrize("per_token", [False, True])
def test_block_matches(per_token):
    """The first block in the JAX form (its cross-attention on the key mask)
    against the JAX block on the -10000 bias, fed one timestep_6d an example
    or, per token, the adaLN-single of t and of 0 on the first frame's
    tokens (D3) (rel L2 1e-4)."""
    ref = reference()
    pipe, (inputs, _, _) = _inputs(ref, 1.0 if per_token else 0.0)
    model = pipe.model
    with torch.no_grad():
        t6, _ = model.adaln_single(inputs["t"])
        cos, sin = tltx.ltx_rope_tables(inputs["fractional_coords"][0].transpose(0, 1), 48,
                                        10000.0, (20, 2048, 2048))
        got = model.blocks[0](torch.from_numpy(ref["x_blk"]), t6, torch.from_numpy(ref["ctx"]),
                              inputs["prompt_mask"], cos, sin)
    assert rel_l2(got.numpy(), ref["res"]["block_tok" if per_token else "block"]) < 1e-4


def test_forward_and_lora_grads_match():
    """The whole module in the JAX form from the JAX noise and t: output,
    loss and every LoRA gradient."""
    ref = reference()
    pipe, (inputs, target, mask) = _inputs(ref)
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(n))
    out = pipe.forward(inputs)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    res = ref["res"]
    assert rel_l2(out.detach().numpy(), res["out"]) < 1e-4
    np.testing.assert_allclose(loss.item(), float(res["loss"]), rtol=1e-5)
    want = ltx_video_state_dict(res["grads"])
    factors = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    assert set(factors) == set(want) and len(want) == 2 * 2 * 10
    for n, g in want.items():
        np.testing.assert_allclose(factors[n].grad.numpy(), g.numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=n)


def published_block(block, x, t6, ctx, mask, cos, sin):
    """Lightricks' BasicTransformerBlock with rms_norm / single_scale_shift,
    written out on the port block's weights: RMS pre-norms without affine,
    the raw stream into attn2, SDPA with a boolean key mask."""
    def lin(m, v):
        return v @ m.weight.t() + m.bias

    def rms(v, scale=None):
        v = v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + 1e-6)
        return v if scale is None else v * scale

    def attn(q, k, v, m=None):
        b, s, _ = q.shape
        q, k, v = (z.reshape(b, z.shape[1], 4, -1).transpose(1, 2) for z in (q, k, v))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=m)
        return o.transpose(1, 2).reshape(b, s, -1)

    def rope(v):
        pairs = v.reshape(*v.shape[:-1], -1, 2)
        rot = torch.stack([-pairs[..., 1], pairs[..., 0]], -1).reshape(v.shape)
        return v * cos.repeat_interleave(2, -1) + rot * sin.repeat_interleave(2, -1)

    mods = block.scale_shift_table[None, None] + t6.reshape(x.shape[0], -1, 6, x.shape[-1])
    sh1, sc1, g1, sh2, sc2, g2 = mods.unbind(2)
    h = rms(x) * (1 + sc1) + sh1
    q = rope(rms(lin(block.attn1_to_q, h), block.attn1_norm_q.scale))
    k = rope(rms(lin(block.attn1_to_k, h), block.attn1_norm_k.scale))
    x = x + g1 * lin(block.attn1_to_out, attn(q, k, lin(block.attn1_to_v, h)))
    q = rms(lin(block.attn2_to_q, x), block.attn2_norm_q.scale)
    k = rms(lin(block.attn2_to_k, ctx), block.attn2_norm_k.scale)
    m = mask.bool()[:, None, None, :]
    x = x + lin(block.attn2_to_out, attn(q, k, lin(block.attn2_to_v, ctx), m))
    h = rms(x) * (1 + sc2) + sh2
    return x + g2 * lin(block.ff_out, F.gelu(lin(block.ff_in, h), approximate="tanh"))


def test_d1_d2_published_block():
    """The port's published block (jax_form off) against the plain-torch
    construction (rel L2 1e-5), and apart from the JAX form's output."""
    ref = reference()
    pipe, (inputs, _, _) = _inputs(ref)
    cfg = dataclasses.replace(pipe.ltx_config, jax_form=False)
    block = tltx.LTXBlock(cfg)
    block.load_state_dict(pipe.model.blocks[0].state_dict())
    with torch.no_grad():  # the adapters off: the construction reads the base weights
        for n, p in block.named_parameters():
            if n.endswith("lora_b"):
                p.zero_()
    x, ctx = torch.from_numpy(ref["x_blk"]), torch.from_numpy(ref["ctx"])
    cos, sin = (torch.tensor(ref["res"][k]) for k in ("cos", "sin"))
    with torch.no_grad():
        t6, _ = pipe.model.adaln_single(inputs["t"])
        got = block(x, t6, ctx, inputs["prompt_mask"], cos, sin)
        want = published_block(block, x, t6, ctx, inputs["prompt_mask"], cos, sin)
    assert rel_l2(got.numpy(), want.numpy()) < 1e-5
    assert rel_l2(got.numpy(), ref["res"]["block"]) > 1e-2


def test_keymap_load_export_reimport(tmp_path):
    """The KeyMap against the JAX keymap_from_flax; the single file loads bit
    for bit (its vae.* keys left to the VAE), raises on a missing and an
    untaken key; the LoRA export has the JAX export's keys and tensors and
    comes back bit for bit."""
    ref = reference()
    pipe = port_pipeline(ref)
    jpipe = ref["jpipe"]
    frozen = partition_params(ref["params"], jax_lora)[1]
    jsd = jkm.keymap_from_flax(frozen, jpipe.keymap(), jpipe.ltx_config)
    weights = {k: v for k, v in ltx_video_state_dict(ref["params"]).items() if "lora" not in k}
    out = tkm.keymap_from_state_dict(weights, pipe.keymap(), pipe.ltx_config)
    assert set(out) == set(jsd)
    for k, v in jsd.items():
        assert torch.equal(out[k], torch.from_numpy(np.ascontiguousarray(v))), k
    path = tmp_path / "ltx.safetensors"
    single = {"model.diffusion_model." + k: v for k, v in out.items()}
    single["vae.encoder.conv_in.conv.weight"] = torch.zeros(2, 12, 3, 3, 3)
    safetensors_io.save_file(single, str(path))
    mcfg = dict(CFG, model=dict(CFG["model"], single_file_path=str(path)))
    loaded = get_model_class("ltx-video")(mcfg, device="cpu").load_weights()
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k])
                                               for k in loaded)
    for name, bad, match in (
            ("missing", {k: v for k, v in out.items() if k != "scale_shift_table"},
             "scale_shift_table"),
            ("untaken", {**out, "transformer_blocks.0.attn3.to_q.weight": torch.zeros(1)},
             "attn3")):
        p = tmp_path / f"{name}.safetensors"
        safetensors_io.save_file(bad, str(p))
        with pytest.raises(KeyError, match=match):
            get_model_class("ltx-video")(
                dict(CFG, model=dict(CFG["model"], transformer_path=str(p))),
                device="cpu").load_weights()

    factors = {k: v.detach() for k, v in pipe.model.state_dict().items() if lora_predicate(k)}
    pipe.save_adapter(tmp_path / "adapter", factors)
    saved = safetensors_io.load_file(tmp_path / "adapter" / "adapter_model.safetensors")
    jax_export = jkm.export_lora_keymap(ref["trainable"], jpipe.keymap(), jpipe.ltx_config)
    assert {k for k in saved if not k.endswith(".alpha")} == set(jax_export)
    for k, v in jax_export.items():
        assert torch.equal(saved[k], torch.from_numpy(np.ascontiguousarray(v))), k
    back = pipe.load_adapter(tmp_path / "adapter")
    assert set(back) == set(factors) and all(torch.equal(back[k], factors[k]) for k in back)


def test_layout_comes_from_the_checkpoint(tmp_path):
    """load_weights rebuilds the model on the keys' layout (1 block, 40 wide,
    12 latent channels, caption 20, MLP ratio 2) and loads it bit for bit; a
    [model] depth that disagrees raises."""
    pipe = get_model_class("ltx-video")(CFG, device="cpu")
    layout = dict(num_layers=1, hidden_size=40, in_channels=12, out_channels=12,
                  caption_dim=20, mlp_ratio=2.0)
    cfg = dataclasses.replace(pipe.ltx_config, **layout)
    src = tltx.LTXTransformer(cfg)
    init_module_weights(src, torch.Generator().manual_seed(3))
    weights = {k: v for k, v in src.state_dict().items() if not lora_predicate(k)}
    path = tmp_path / "model.safetensors"
    safetensors_io.save_file(
        tkm.keymap_from_state_dict(weights, tltx.ltx_video_keymap(cfg), cfg), str(path))
    mc = dict(CFG["model"], transformer_path=str(path))
    pipe = get_model_class("ltx-video")(dict(CFG, model=mc), device="cpu")
    loaded = pipe.load_weights()
    assert all(getattr(pipe.ltx_config, k) == v for k, v in layout.items())
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k]) for k in loaded)
    with pytest.raises(KeyError, match="num_layers"):
        get_model_class("ltx-video")(dict(CFG, model=dict(mc, num_layers=2)),
                                     device="cpu").load_weights()
