"""LTX-2's video path in the port vs the JAX package.

The `_tiny` config (2 blocks, 32 wide in 4 heads of 8, 16 latent channels,
caption 24 (+ 8 of audio), RoPE (4, 2, 2), a 1-block connector of 4
registers padding to 16 rows, f32) with LoRA rank 4, LoRA B nonzero, on
seeded numpy weights crossed with interop.ltx2_state_dict (the connector's
`attn_q_{i}` as `blocks.{i}.attn_q`). The batch: latents of 2 x 4 x 4 (32
tokens), 8 Gemma rows of which 5 and 3 are valid, a loss mask.

One jit holds the JAX side, from the JAX prepare_inputs' noise and t: the
module's output, loss and LoRA gradients; the output on caption rows 32
wide (the dual stream: the video half taken); the connector on projected
rows with their mask; the first block. Tolerances (f32): rel L2 1e-4 on
outputs, the connector and the block, the loss 1e-5 relative, gradients
1e-4 abs / 1e-3 rel.

Exact: prepare_inputs' tokens, target, coordinates and token mask; the
KeyMap against the JAX keymap_from_flax (the connector's
transformer_1d_blocks names); a single file with an audio branch and
`vae.*` keys loading bit for bit, the audio tensors carried into a full
export; a missing and an untaken key raising; the LoRA export with the JAX
export's keys and tensors and its re-import; a layout from the keys.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models import keymaps as jkm
from diffusion_pipe_tpu.models import ltx2 as jltx2
from diffusion_pipe_tpu.models.layers import rope_frequencies as jax_rope
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import ltx2_config, ltx2_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models import ltx2 as tltx2
from diffusion_pipe_tpu_torch.models.layers import init_module_weights, rope_frequencies
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, jax_draws, random_params

KEY = jax.random.PRNGKey(21)
CFG = {"save_every_n_epochs": 1,
       "model": {"type": "ltx2", "dtype": "float32", "_tiny": True},
       "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
       "optimizer": {"type": "adamw", "lr": 1e-3}}
FHW = (2, 4, 4)
S = 32


def ltx2_batch(seed=45):
    rng = np.random.default_rng(seed)
    mask = np.zeros((2, 8), np.int32)
    mask[0, :5], mask[1, :3] = 1, 1
    return {"latents": (rng.standard_normal((2, 16, *FHW)) * 0.5).astype(np.float32),
            "text_embeds_0": rng.standard_normal((2, 8, 24)).astype(np.float32),
            "attention_mask_0": mask,
            "mask": (rng.random((2, 12, 20)) > 0.4).astype(np.float32)}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@functools.lru_cache(maxsize=None)
def reference():
    """The JAX pipeline, weights, batch and results (one jit)."""
    jpipe = jax_model_class("ltx2")(CFG)
    params = random_params(jpipe, seed=17, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    batch = ltx2_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = jpipe.ltx2_config
    rng = np.random.default_rng(5)
    bi = dict(x=rng.standard_normal((2, S, 32)).astype(np.float32),
              t6=rng.standard_normal((2, 6 * 32)).astype(np.float32),
              p2=rng.standard_normal((2, 2 * 32)).astype(np.float32),
              ctx=rng.standard_normal((2, 16, 32)).astype(np.float32),
              rows=rng.standard_normal((2, 8, 32)).astype(np.float32),
              wide=rng.standard_normal((2, 8, 32)).astype(np.float32))

    def loss(tr, fr, mi, target, lmask):
        out = jpipe.model.apply(merge_params(tr, fr), **mi)
        return jpipe.loss_fn(out, target, lmask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(tr, fr):
        mi, target, lmask = jpipe.prepare_inputs(KEY, jbatch)
        (l, out), grads = jax.value_and_grad(loss, has_aux=True)(tr, fr, mi, target, lmask)
        whole = merge_params(tr, fr)
        p = whole["params"]
        dual = jpipe.model.apply(whole, **dict(mi, prompt_embeds=bi["wide"]))
        conn = jltx2.Connector1D(cfg, 32).apply(
            {"params": p["video_embeddings_connector"]}, bi["rows"], jbatch["attention_mask_0"])
        ids = jnp.transpose(mi["fractional_coords"][0], (1, 0))
        cos, sin = jax_rope(ids, cfg.rope_axes_dim, cfg.rope_theta)
        blk, _ = jltx2.LTX2Block(cfg).apply(
            {"params": jax.tree.map(lambda a: a[0], p["blocks"])}, bi["x"], bi["t6"][:, None],
            bi["p2"], bi["ctx"], cos, sin)
        return dict(loss=l, out=out, grads=grads, dual=dual, conn=conn, block=blk, x=mi["x"],
                    t=mi["t"], coords=mi["fractional_coords"], target=target, lmask=lmask)

    res = jax.tree.map(np.asarray, run(trainable, frozen))
    return dict(jpipe=jpipe, params=jax.tree.map(np.asarray, params), trainable=trainable,
                batch=batch, bi=bi, res=res)


def port_pipeline(ref):
    pipe = get_model_class("ltx2")(CFG, device="cpu")
    want = ltx2_config(ref["jpipe"].ltx2_config)
    assert pipe.ltx2_config == want
    pipe.model = tltx2.LTX2Transformer(want)
    pipe.model.load_state_dict(ltx2_state_dict(ref["params"]))
    return pipe


def _inputs(ref, pipe):
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    noise, t = jax_draws(ref["jpipe"], KEY, ref["batch"])
    return pipe.prepare_inputs(batch, noise=noise, t=t)


def test_config_is_the_jax_tiny_and_published_defaults():
    """The port's `_tiny` config is the JAX one through interop; the
    published defaults: 48 blocks of 4,096 in 32 heads of 128, RoPE (32, 48,
    48), a 2-block connector of 128 registers padding to 1,024 rows in heads
    of 64, 12.9 B in the blocks."""
    pipe = get_model_class("ltx2")({"model": {"type": "ltx2"}}, device="cpu")
    c = pipe.ltx2_config
    assert (c.num_layers, c.hidden_size, c.num_heads, c.head_dim, c.rope_axes_dim,
            c.connector_blocks, c.connector_registers, c.connector_min_len) == (
        48, 4096, 32, 128, (32, 48, 48), 2, 128, 1024)
    n = sum(p.numel() for p in pipe.model.blocks.parameters())
    assert round(n / 1e9, 1) == 12.9, n


def test_prepare_inputs_matches():
    """Tokens, target, t, the (frame / 24, h, w) coordinates and the token
    mask from the JAX noise and t."""
    ref = reference()
    inputs, target, mask = _inputs(ref, port_pipeline(ref))
    res = ref["res"]
    np.testing.assert_allclose(inputs["x"].numpy(), res["x"], atol=1e-6)
    np.testing.assert_allclose(target.numpy(), res["target"], atol=1e-6)
    np.testing.assert_array_equal(inputs["t"].numpy(), res["t"])
    np.testing.assert_allclose(inputs["fractional_coords"].numpy(), res["coords"], rtol=1e-7)
    np.testing.assert_array_equal(mask.numpy(), res["lmask"])


@pytest.mark.parametrize("part", ["connector", "block"])
def test_parts_match(part):
    """The connector (rows padded by the registers to 16, 1-D RoPE, the
    final norm) and the first block (prompt-modulated, unmasked
    cross-attention) against the JAX modules (rel L2 1e-4)."""
    ref = reference()
    pipe = port_pipeline(ref)
    bi = {k: torch.from_numpy(v) for k, v in ref["bi"].items()}
    with torch.no_grad():
        if part == "connector":
            mask = torch.from_numpy(ref["batch"]["attention_mask_0"])
            got = pipe.model.video_embeddings_connector(bi["rows"], mask)
            assert got.shape == (2, 16, 32)
        else:
            coords = torch.tensor(ref["res"]["coords"][0]).transpose(0, 1)
            cos, sin = rope_frequencies(coords, (4, 2, 2), 10000.0)
            got = pipe.model.blocks[0](bi["x"], bi["t6"], bi["p2"], bi["ctx"], cos, sin)
    assert rel_l2(got.numpy(), ref["res"]["conn" if part == "connector" else "block"]) < 1e-4


def test_forward_and_lora_grads_match():
    """The whole module from the JAX noise and t: output, loss, every LoRA
    gradient, and the output on 32-wide dual-stream rows."""
    ref = reference()
    pipe = port_pipeline(ref)
    inputs, target, mask = _inputs(ref, pipe)
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(n))
    out = pipe.forward(inputs)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    res = ref["res"]
    assert rel_l2(out.detach().numpy(), res["out"]) < 1e-4
    np.testing.assert_allclose(loss.item(), float(res["loss"]), rtol=1e-5)
    want = ltx2_state_dict(res["grads"])
    factors = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    assert set(factors) == set(want) and len(want) == 2 * 2 * 10
    for n, g in want.items():
        np.testing.assert_allclose(factors[n].grad.numpy(), g.numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=n)
    with torch.no_grad():
        dual = pipe.forward(dict(inputs, prompt_embeds=torch.from_numpy(ref["bi"]["wide"])))
    assert rel_l2(dual.numpy(), res["dual"]) < 1e-4


def test_keymap_load_export_reimport(tmp_path):
    """The KeyMap against the JAX keymap_from_flax; a single file with an
    audio branch and vae.* keys loads bit for bit, carries the audio
    tensors into a full export, raises on a missing and an untaken key; the
    LoRA export has the JAX export's keys and tensors and comes back bit
    for bit."""
    ref = reference()
    pipe = port_pipeline(ref)
    jpipe = ref["jpipe"]
    frozen = partition_params(ref["params"], jax_lora)[1]
    jsd = jkm.keymap_from_flax(frozen, jpipe.keymap(), jpipe.ltx2_config)
    weights = {k: v for k, v in ltx2_state_dict(ref["params"]).items() if "lora" not in k}
    out = tkm.keymap_from_state_dict(weights, pipe.keymap(), pipe.ltx2_config)
    assert set(out) == set(jsd)
    assert "video_embeddings_connector.transformer_1d_blocks.0.attn.q_proj.weight" in out
    for k, v in jsd.items():
        assert torch.equal(out[k], torch.from_numpy(np.ascontiguousarray(v))), k
    audio = {"audio_proj_out.weight": torch.ones(3, 2), "av_ca_video.linear.bias": torch.ones(3)}
    path = tmp_path / "ltx2.safetensors"
    single = {"model.diffusion_model." + k: v for k, v in {**out, **audio}.items()}
    single["vae.per_channel_statistics.mean-of-means"] = torch.zeros(16)
    safetensors_io.save_file(single, str(path))
    mcfg = dict(CFG, model=dict(CFG["model"], single_file_path=str(path)))
    loader = get_model_class("ltx2")(mcfg, device="cpu")
    loaded = loader.load_weights()
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k])
                                               for k in loaded)
    loader.model = tltx2.LTX2Transformer(loader.ltx2_config)
    loader.model.load_state_dict(loaded, strict=False)
    loader.save_model(tmp_path / "full", loader.model)
    full = safetensors_io.load_file(tmp_path / "full" / "model.safetensors")
    assert set(full) == set(out) | set(audio)
    for name, bad, match in (
            ("missing", {k: v for k, v in out.items() if k != "prompt_adaln_single.linear.weight"},
             "prompt_adaln_single"),
            ("untaken", {**out, "transformer_blocks.0.attn3.to_q.weight": torch.zeros(1)},
             "attn3")):
        p = tmp_path / f"{name}.safetensors"
        safetensors_io.save_file(bad, str(p))
        with pytest.raises(KeyError, match=match):
            get_model_class("ltx2")(dict(CFG, model=dict(CFG["model"], transformer_path=str(p))),
                                    device="cpu").load_weights()

    factors = {k: v.detach() for k, v in pipe.model.state_dict().items() if lora_predicate(k)}
    pipe.save_adapter(tmp_path / "adapter", factors)
    saved = safetensors_io.load_file(tmp_path / "adapter" / "adapter_model.safetensors")
    jax_export = jkm.export_lora_keymap(ref["trainable"], jpipe.keymap(), jpipe.ltx2_config)
    assert {k for k in saved if not k.endswith(".alpha")} == set(jax_export)
    for k, v in jax_export.items():
        assert torch.equal(saved[k], torch.from_numpy(np.ascontiguousarray(v))), k
    back = pipe.load_adapter(tmp_path / "adapter")
    assert set(back) == set(factors) and all(torch.equal(back[k], factors[k]) for k in back)


def test_layout_comes_from_the_checkpoint(tmp_path):
    """load_weights rebuilds the model on the keys' layout (1 block, 40 wide,
    12 latent channels, caption 20, 2 connector blocks of 3 registers) and
    loads it bit for bit; a [model] depth that disagrees raises."""
    pipe = get_model_class("ltx2")(CFG, device="cpu")
    layout = dict(num_layers=1, hidden_size=40, in_channels=12, out_channels=12,
                  cross_attention_dim=20, connector_blocks=2, connector_registers=3)
    cfg = dataclasses.replace(pipe.ltx2_config, rope_axes_dim=(4, 2, 4), **layout)
    src = tltx2.LTX2Transformer(cfg)
    init_module_weights(src, torch.Generator().manual_seed(3))
    weights = {k: v for k, v in src.state_dict().items() if not lora_predicate(k)}
    path = tmp_path / "model.safetensors"
    safetensors_io.save_file(tkm.keymap_from_state_dict(weights, tltx2.ltx2_keymap(cfg), cfg),
                             str(path))
    mc = dict(CFG["model"], transformer_path=str(path))
    pipe = get_model_class("ltx2")(dict(CFG, model=mc), device="cpu")
    loaded = pipe.load_weights()
    assert all(getattr(pipe.ltx2_config, k) == v for k, v in layout.items())
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k]) for k in loaded)
    with pytest.raises(KeyError, match="num_layers"):
        get_model_class("ltx2")(dict(CFG, model=dict(mc, num_layers=2)),
                                device="cpu").load_weights()
