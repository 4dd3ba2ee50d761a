"""Tiny FLUX.2 in the port vs the JAX package.

The `_tiny` sizes (2 + 2 blocks, 4 heads of 8, text 24 wide, 4 latent
channels, f32) with LoRA rank 4, LoRA B nonzero. Two layouts:

- the JAX module's (GELU MLP at ratio 4, biased embedders / modulations /
  head, txt_norm, 3 RoPE axes at theta 10,000): seeded numpy weights on
  the JAX parameter structure (tests/torch_port_helpers.py), carried by
  interop.py (flux2_config, jax_to_state_dict), against the JAX
  Flux2Transformer through the JAX prepare_inputs' noise and t: output,
  loss and every LoRA gradient, plain (with a loss mask) and edit
  (control latents after the target, the output cut to its rows);
- the published one (SwiGLU at ratio 3, no biases, no txt_norm, 4 RoPE axes
  (t, h, w, l) at theta 2,000, the reference image at t = 10): the port's
  seeded weights against torch_port_helpers.flux2_published, the JAX
  submodules composed as the published model computes. The JAX module on
  the JAX weights differs from that composition run with the published
  RoPE and ids (checked), so the published layout has no JAX whole-module
  reference.

One jit gives every JAX number. Tolerances (f32): outputs 1e-4, losses 1e-5
relative, LoRA gradients 1e-4 abs / 1e-3 rel (f32 sums in another order).
The ids, the layout read from checkpoint keys, the keymap (bit for bit
against the JAX keymap in the JAX layout), the adapter export and import
(bit for bit), the stacked text layers and the VAE's batch-norm statistics
are exact.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models import keymaps as jkm
from diffusion_pipe_tpu.models.flux2 import _latent_ids
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import flux2_config, jax_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models.flux2 import (Flux2Transformer, flux2_checkpoint_layout,
                                                   flux2_latent_ids, flux2_text_ids,
                                                   flux2_text_layers)
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import (JAX_FAST_COMPILE, flux2_published, jax_draws,
                                port_to_jax_leaves, random_params)

KEY = jax.random.PRNGKey(4)


def flux2_cfg(**model):
    return {"save_every_n_epochs": 1,
            "model": {"type": "flux2", "dtype": "float32", "_tiny": True, **model},
            "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
            "optimizer": {"type": "adamw", "lr": 1e-3}}


def flux2_batch(seed, edit=False):
    rng = np.random.default_rng(seed)
    batch = {"latents": (rng.standard_normal((2, 4, 8, 12)) * 0.5).astype(np.float32),
             "text_embeds_0": rng.standard_normal((2, 8, 24)).astype(np.float32)}
    if edit:
        batch["control_latents"] = rng.standard_normal((2, 4, 8, 12)).astype(np.float32)
    else:
        batch["mask"] = (rng.random((2, 12, 20)) > 0.5).astype(np.float32)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def published_pipeline(seed=3):
    """The port's tiny FLUX.2 in the published layout, seeded, LoRA B nonzero."""
    pipe = get_model_class("flux2")(flux2_cfg(), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    pipe.init_params(gen)
    with torch.no_grad():
        for name, p in pipe.model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
            elif name.endswith(".scale"):
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return pipe


def jax_layout_pipeline(jpipe, params=None, **over):
    """The port's pipeline computing the JAX module (interop.flux2_config)."""
    pipe = get_model_class("flux2")(flux2_cfg(), device="cpu")
    pipe.f2_config = flux2_config(jpipe.f2_config, **over)
    pipe.model = Flux2Transformer(pipe.f2_config)
    if params is not None:
        pipe.model.load_state_dict(jax_to_state_dict(params))
    return pipe


def _pub_ids(cfg, h, w, n_images):
    return np.concatenate([flux2_latent_ids(h // 2, w // 2, cfg.ref_index_scale * i, 4).numpy()
                           for i in range(n_images)])


@pytest.fixture(scope="module")
def ref():
    cfg = flux2_cfg()
    jpipe = jax_model_class("flux2")(cfg)
    params = random_params(jpipe, seed=5, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    tpub = published_pipeline()
    pcfg = tpub.f2_config
    leaves = port_to_jax_leaves(tpub.model.state_dict())
    pub_lora = {k: {n: v for n, v in d.items() if n.startswith("lora_")}
                for k, d in leaves.items() if "lora_a" in d}
    pub_rest = {k: {n: v for n, v in d.items() if not n.startswith("lora_")}
                for k, d in leaves.items()}
    plain, edit = flux2_batch(11), flux2_batch(12, edit=True)
    jplain, jedit = ({k: jnp.asarray(v) for k, v in b.items()} for b in (plain, edit))
    ids = {n: jnp.asarray(_pub_ids(pcfg, 8, 12, n)) for n in (1, 2)}
    # the JAX layout's weights run with the published RoPE and ids
    rope_pub = dataclasses.replace(flux2_config(jpipe.f2_config), axes_dims_rope=(2, 2, 2, 2),
                                   txt_ids_dims=(3,), rope_theta=2000.0)
    jleaves = port_to_jax_leaves(jax_to_state_dict(params))

    def jax_loss(tr, jbatch):
        mi, target, mask = jpipe.prepare_inputs(KEY, jbatch)
        out = jpipe.model.apply(merge_params(tr, frozen), **mi)
        return jpipe.loss_fn(out, target, mask), out

    def pub_out(lora, jbatch, n_images):
        mi, target, mask = jpipe.prepare_inputs(KEY, jbatch)
        p = {k: {**v, **lora.get(k, {})} for k, v in pub_rest.items()}
        out = flux2_published(pcfg, p, mi["hidden_states"], mi["encoder_hidden_states"],
                              mi["timestep"], ids[n_images], mi["guidance"], mi["img_seq_len"])
        return jpipe.loss_fn(out, target, mask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(tr, lora):
        (jl, jo), jg = jax.value_and_grad(jax_loss, has_aux=True)(tr, jplain)
        (pl, po), pg = jax.value_and_grad(lambda lo: pub_out(lo, jplain, 1),
                                          has_aux=True)(lora)
        mi, _, _ = jpipe.prepare_inputs(KEY, jplain)
        pub_rope = flux2_published(rope_pub, jleaves, mi["hidden_states"],
                                   mi["encoder_hidden_states"], mi["timestep"], ids[1],
                                   mi["guidance"])
        return dict(jax_loss=jl, jax_out=jo, jax_grads=jg, pub_loss=pl, pub_out=po,
                    pub_grads=pg, jax_edit=jax_loss(tr, jedit)[1],
                    pub_edit=pub_out(lora, jedit, 2)[1], pub_rope=pub_rope)

    r = jax.tree.map(np.asarray, run(trainable, pub_lora))
    r["jax_grads"] = jax_to_state_dict(r["jax_grads"])
    return dict(r, jpipe=jpipe, params=params, tpub=tpub, plain=plain, edit=edit)


def _check_grads(model, grads_by_name, n):
    lora = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert set(lora) == set(grads_by_name) and len(lora) == n
    for name, p in lora.items():
        np.testing.assert_allclose(p.grad.numpy(), grads_by_name[name], atol=1e-4, rtol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("remat", [False, "full", "attn"])
def test_jax_layout_matches_the_jax_module(ref, remat):
    """interop's JAX layout: prepare_inputs, output, loss and every LoRA
    gradient of the JAX Flux2Transformer, under the checkpointing policies."""
    pipe = jax_layout_pipeline(ref["jpipe"], ref["params"], remat=remat or "")
    noise, t = jax_draws(ref["jpipe"], KEY, ref["plain"])
    inputs, target, mask = pipe.prepare_inputs(_tbatch(ref["plain"]), noise=noise, t=t)
    assert inputs["img_ids"].shape == (24, 3) and inputs["img_seq_len"] is None
    for name, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(name))
    out = pipe.forward(inputs)
    np.testing.assert_allclose(out.detach().numpy(), ref["jax_out"], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref["jax_loss"]), rtol=1e-5)
    _check_grads(pipe.model, {k: v.numpy() for k, v in ref["jax_grads"].items()}, 2 * 10 * 2)


def test_jax_layout_edit_matches_the_jax_module(ref):
    """The edit batch: control latents packed after the target with the JAX
    ids (axis-0 index 1), the output cut to the target's 24 rows."""
    pipe = jax_layout_pipeline(ref["jpipe"], ref["params"])
    noise, t = jax_draws(ref["jpipe"], KEY, ref["edit"])
    inputs, _, _ = pipe.prepare_inputs(_tbatch(ref["edit"]), noise=noise, t=t)
    want_ids = np.concatenate([_latent_ids(4, 6), _latent_ids(4, 6, index=1)])
    np.testing.assert_array_equal(inputs["img_ids"].numpy(), want_ids)
    assert inputs["hidden_states"].shape[1] == 48 and inputs["img_seq_len"] == 24
    with torch.no_grad():
        out = pipe.forward(inputs)
    np.testing.assert_allclose(out.numpy(), ref["jax_edit"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["plain", "edit"])
def test_published_layout_matches_its_oracle(ref, mode):
    """The published layout (SwiGLU, no biases, no txt_norm, 4 RoPE axes at
    theta 2,000, the reference image at t = 10) against the JAX submodules
    composed so; plain: output, loss and LoRA gradients."""
    pipe = ref["tpub"]
    batch = ref[mode]
    noise, t = jax_draws(ref["jpipe"], KEY, batch)
    inputs, target, mask = pipe.prepare_inputs(_tbatch(batch), noise=noise, t=t)
    for name, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(name))
        p.grad = None
    out = pipe.forward(inputs)
    want = ref["pub_out"] if mode == "plain" else ref["pub_edit"]
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-4, rtol=1e-4)
    if mode == "edit":
        assert inputs["img_ids"][24:, 0].eq(10).all()
        return
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref["pub_loss"]), rtol=1e-5)
    grads = {f"{k}.{leaf}": v for k, d in ref["pub_grads"].items() for leaf, v in d.items()}
    _check_grads(pipe.model, grads, 2 * 10 * 2)


def test_jax_module_differs_from_the_published_rope(ref):
    """On the same weights, the JAX module's 3-axis RoPE and ids and the
    published 4-axis ones give different outputs."""
    assert np.abs(ref["jax_out"] - ref["pub_rope"]).max() > 1e-2


def test_ids_against_a_hand_table():
    """Published ids (t, h, w, l): a 2 x 3 packed image at t = 0 and the
    reference at t = 10; text positions on l; the JAX layout's on axis 0."""
    img = flux2_latent_ids(2, 3, 0, 4)
    assert img.tolist() == [[0, 0, 0, 0], [0, 0, 1, 0], [0, 0, 2, 0],
                            [0, 1, 0, 0], [0, 1, 1, 0], [0, 1, 2, 0]]
    assert flux2_latent_ids(1, 2, 10, 4).tolist() == [[10, 0, 0, 0], [10, 0, 1, 0]]
    pub = get_model_class("flux2")(flux2_cfg(), device="cpu").f2_config
    assert flux2_text_ids(3, pub).tolist() == [[0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2]]
    jax_cfg = flux2_config(jax_model_class("flux2")(flux2_cfg()).f2_config)
    assert flux2_text_ids(2, jax_cfg).tolist() == [[0, 0, 0], [1, 0, 0]]
    assert flux2_latent_ids(1, 2, 1, 3).tolist() == _latent_ids(1, 2, index=1).tolist()


def _assert_same(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k, v in want.items():
        w = torch.as_tensor(np.asarray(v))
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_keymap_matches_jax_in_the_jax_layout(ref, tmp_path):
    """The ComfyUI keys: a checkpoint made by the JAX keymap_from_flax loads
    through the port's map to exactly jax_to_state_dict(keymap_to_flax(...));
    the port's export of the same weights is the JAX export; the LoRA export
    equals the JAX export_lora_keymap's keys and bits."""
    jpipe = ref["jpipe"]
    tp = jax_layout_pipeline(jpipe)
    np_params = jax.tree.map(np.asarray, ref["params"])
    ckpt = jkm.keymap_from_flax(np_params, jpipe.keymap(), jpipe._keymap_config())
    assert "txt_norm.scale" in ckpt and "img_in.bias" in ckpt
    port_ckpt = tkm.keymap_from_state_dict(jax_to_state_dict(np_params), tp.keymap(),
                                           tp.f2_config)
    _assert_same(port_ckpt, ckpt)
    loaded = tkm.keymap_to_state_dict({k: torch.from_numpy(v) for k, v in ckpt.items()},
                                      tp.keymap(), tp.f2_config)
    _assert_same(loaded, jax_to_state_dict(jkm.keymap_to_flax(ckpt, jpipe.keymap(),
                                                              jpipe._keymap_config())))
    trainable, _ = partition_params(np_params, jax_lora)
    want = jkm.export_lora_keymap(trainable, jpipe.keymap(), jpipe._keymap_config())
    _assert_same(tkm.export_lora_keymap(jax_to_state_dict(trainable), tp.keymap(),
                                        tp.f2_config), want)
    layout = flux2_checkpoint_layout(ckpt)
    assert layout == dict(hidden_size=32, in_channels=16, out_channels=16, num_layers=2,
                          num_single_layers=2, attention_head_dim=8, mlp_gated=False,
                          mlp_ratio=4.0, use_bias=True, txt_norm=True, guidance_embeds=True,
                          text_dim=24)


def _published_checkpoint(pipe):
    return tkm.keymap_from_state_dict(pipe.model.state_dict(), pipe.keymap(), pipe.f2_config)


@pytest.mark.parametrize("case", ["from_checkpoint", "model_config_disagrees"])
def test_layout_comes_from_the_checkpoint(ref, tmp_path, case):
    """A published-layout file (3 double blocks, SwiGLU, no bias, no
    txt_norm) rebuilds a JAX-sized pipeline on its layout and loads every
    weight; [model] naming another block count raises."""
    src = published_pipeline()
    cfg = dataclasses.replace(src.f2_config, num_layers=3)
    src.f2_config, src.model = cfg, Flux2Transformer(cfg)
    from diffusion_pipe_tpu_torch.models.layers import init_module_weights

    init_module_weights(src.model, torch.Generator().manual_seed(1))
    ckpt = {k: v for k, v in _published_checkpoint(src).items()}
    assert "img_in.bias" not in ckpt and "txt_norm.scale" not in ckpt
    assert ckpt["double_blocks.0.img_mlp.0.weight"].shape == (192, 32)
    safetensors_io.save_file({k: v.contiguous() for k, v in ckpt.items()},
                             str(tmp_path / "flux2.safetensors"))
    model = {"transformer_path": str(tmp_path / "flux2.safetensors")}
    if case == "model_config_disagrees":
        model["num_layers"] = 2
    pipe = get_model_class("flux2")(flux2_cfg(**model), device="cpu")
    if case == "model_config_disagrees":
        with pytest.raises(KeyError, match="num_layers"):
            pipe.load_weights()
        return
    pipe = get_model_class("flux2")(dict(flux2_cfg(**model), adapter={}), device="cpu")
    pipe.f2_config = flux2_config(ref["jpipe"].f2_config)  # start from the other layout
    sd = pipe.load_weights()
    c = pipe.f2_config
    assert (c.num_layers, c.mlp_gated, c.use_bias, c.txt_norm, c.mlp_ratio) == (
        3, True, False, False, 3.0)
    want = {k: v for k, v in src.model.state_dict().items() if "lora" not in k}
    assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in want)


def test_adapter_export_and_reimport(ref, tmp_path):
    """The published layout's LoRA under `diffusion_model.` (ComfyUI), 20
    pairs with their alphas, read back bit for bit."""
    pipe = ref["tpub"]
    factors = {k: v.detach().clone() for k, v in pipe.model.state_dict().items()
               if lora_predicate(k)}
    pipe.save_adapter(tmp_path, factors)
    saved = safetensors_io.load_file(tmp_path / "adapter_model.safetensors")
    assert sum(k.endswith(".lora_A.weight") for k in saved) == 20
    assert all(k.startswith("diffusion_model.") for k in saved)
    assert "diffusion_model.single_blocks.1.linear1.lora_B.weight" in saved
    back = pipe.load_adapter(tmp_path)
    assert set(back) == set(factors) and all(torch.equal(back[k], factors[k]) for k in back)


def test_text_layers_come_from_the_widths():
    """txt_in's width over the LLM's picks the stacked layers: the
    published ones or the last state alone; any other count raises, naming
    the published layouts."""
    mistral3 = {"model_type": "mistral3", "text_config": {"model_type": "mistral",
                                                          "hidden_size": 5120}}
    assert flux2_text_layers(mistral3, 15360) == (10, 20, 30)
    assert flux2_text_layers({"model_type": "qwen3", "hidden_size": 2560}, 7680) == (9, 18, 27)
    assert flux2_text_layers({"model_type": "qwen3", "hidden_size": 2560}, 2560) == (-1,)
    with pytest.raises(ValueError, match=r"mistral layers \(10, 20, 30\)"):
        flux2_text_layers(mistral3, 10240)


def test_vae_latents_take_the_batch_norm_statistics(tmp_path):
    """A FLUX.2-shaped VAE file (32 latent channels, `bn.running_mean` /
    `running_var` over the 128 packed channels, config.json's
    batch_norm_eps): the cached latents are the packed mode normalised by
    them per channel, stored unpacked."""
    from diffusion_pipe_tpu_torch.models.autoencoder_kl import (AutoencoderKL, VAEConfig,
                                                                diffusers_vae_state_dict)
    from diffusion_pipe_tpu_torch.models.flux import pack_latents, unpack_latents

    vae = AutoencoderKL(VAEConfig(latent_channels=32, block_out_channels=(32, 32, 32, 32),
                                  layers_per_block=1, scaling_factor=1.0, shift_factor=0.0))
    vae.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    mean = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    var = torch.from_numpy(rng.uniform(0.5, 2.0, 128).astype(np.float32))
    sd = {**diffusers_vae_state_dict(vae), "bn.running_mean": mean, "bn.running_var": var,
          "bn.num_batches_tracked": torch.tensor(0)}
    (tmp_path / "vae").mkdir()
    safetensors_io.save_file({k: v.contiguous() for k, v in sd.items()},
                             str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors"))
    (tmp_path / "vae" / "config.json").write_text(json.dumps({"batch_norm_eps": 1e-3}))
    pipe = get_model_class("flux2")(flux2_cfg(vae_path=str(tmp_path / "vae"), _tiny=False,
                                              dtype="float32", num_layers=1,
                                              num_single_layers=1), device="cpu")
    pixels = rng.uniform(-1, 1, (2, 3, 32, 48)).astype(np.float32)
    got = pipe.get_call_vae_fn()(pixels)["latents"]
    with torch.no_grad():
        z = vae.encode(torch.from_numpy(pixels))
    packed = (pack_latents(z) - mean) / torch.sqrt(var + 1e-3)
    want = unpack_latents(packed, z.shape[2], z.shape[3])
    assert got.shape == (2, 32, 4, 6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
