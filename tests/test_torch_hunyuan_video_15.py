"""HunyuanVideo-1.5 in the port vs the JAX package.

The `_tiny` config (2 double blocks, 4 heads of 16, a 1-block refiner, 4
latent channels so 9 input channels, patch (1, 2, 2), text 32, byT5 16
through a mapper of 24, RoPE (4, 6, 6), f32) with LoRA rank 4, LoRA B
nonzero. Seeded numpy weights on the JAX parameter structure
(tests/torch_port_helpers.py) cross through
interop.hunyuan_video_15_state_dict (the head's rows reordered from the JAX
module's (pt, ph, pw, c) to hyvideo's (c, pt, ph, pw), cond_type_embedding's
`embedding` as its `weight`). The batch: latents of 3 x 8 x 8 (48 image
tokens), 6 Qwen rows (4 and 2 valid), 4 byT5 rows (2 valid in example 0,
none in example 1), a loss mask.

One jit holds the JAX side, from the JAX prepare_inputs' noise and t: the
module's output, loss and LoRA gradients, the first double block on the
[byT5, text] carry, and the encode of a synthetic HunyuanVideo-1.5-shaped
VAE checkpoint (32 latent channels, five blocks of 8 / 16 wide: 16x in
space, 4x in time). Tolerances (f32): rel L2 1e-4 on the outputs, the
block and the VAE latents; the loss 1e-5 relative; gradients 1e-4 abs /
1e-3 rel.

Exact: prepare_inputs' input [x_t, zeros, zero mask] and t x 1,000; the
KeyMap against the JAX keymap_from_flax; load_weights raising on a missing
and an untaken key; vision_in.* carried from the checkpoint into a full
export; the LoRA export with the JAX export's keys and tensors and its
re-import; a layout read from the keys; the VAE config the port reads from
the checkpoint against the JAX infer_hunyuan_vae_config's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models import hunyuan_vae as jvae
from diffusion_pipe_tpu.models import hunyuan_video_model as jhv
from diffusion_pipe_tpu.models import keymaps as jkm
from diffusion_pipe_tpu.models.layers import rope_frequencies as jax_rope
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import (hunyuan_vae_config, hunyuan_video_15_config,
                                              hunyuan_video_15_state_dict, jax_to_state_dict)
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import hunyuan_vae as tvae
from diffusion_pipe_tpu_torch.models import hunyuan_video_15 as thv15
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models.hunyuan_video_15 import HunyuanVideo15Transformer
from diffusion_pipe_tpu_torch.models.layers import init_module_weights, rope_frequencies
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, jax_draws, random_params

KEY = jax.random.PRNGKey(19)
CFG = {"save_every_n_epochs": 1,
       "model": {"type": "hunyuan_video_15", "dtype": "float32", "_tiny": True},
       "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
       "optimizer": {"type": "adamw", "lr": 1e-3}}
GRID = (3, 4, 4)
VAE_CLIP = (1, 3, 5, 32, 32)
VAE = tvae.HunyuanVAEConfig(block_out_channels=(8, 16, 16, 16, 16), layers_per_block=1,
                            latent_channels=32, quant_convs=False)


def hv15_batch(seed=43):
    rng = np.random.default_rng(seed)
    text_mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0]], np.int32)
    byt5_mask = np.array([[1, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    return {"latents": (rng.standard_normal((2, 4, 3, 8, 8)) * 0.5).astype(np.float32),
            "text_states": rng.standard_normal((2, 6, 32)).astype(np.float32),
            "text_mask": text_mask,
            "byt5_states": rng.standard_normal((2, 4, 16)).astype(np.float32),
            "byt5_mask": byt5_mask,
            "mask": (rng.random((2, 12, 20)) > 0.4).astype(np.float32)}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def vae_checkpoint():
    """A seeded HunyuanVideo-1.5-shaped VAE (VAE) as a checkpoint with the
    causal convolutions' weights under `<name>.weight` (the dialect both
    converters read), and a clip."""
    vae = tvae.HunyuanVAE(VAE)
    vae.init_weights(torch.Generator().manual_seed(5))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(6)
        for n, p in vae.named_parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    sd = {k.replace(".conv.weight", ".weight").replace(".conv.bias", ".bias"): v
          for k, v in vae.state_dict().items()}
    clip = np.random.default_rng(8).uniform(-1, 1, VAE_CLIP).astype(np.float32)
    return sd, clip


@functools.lru_cache(maxsize=None)
def reference():
    """The JAX pipeline, its weights, the batch and the JAX results (one
    jit): the module's loss, output and LoRA gradients; the first double
    block's outputs on the [byT5, text] carry; the VAE checkpoint's
    encode."""
    jpipe = jax_model_class("hunyuan_video_15")(CFG)
    params = random_params(jpipe, seed=15, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    batch = hv15_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = jpipe.hv15_config
    rng = np.random.default_rng(3)
    bi = dict(img=rng.standard_normal((2, 48, cfg.hidden_size)).astype(np.float32),
              txt=rng.standard_normal((2, 10, cfg.hidden_size)).astype(np.float32),
              vec=rng.standard_normal((2, cfg.hidden_size)).astype(np.float32),
              mask=np.concatenate([batch["byt5_mask"], batch["text_mask"]], 1))
    sd, clip = vae_checkpoint()
    sd_np = {k: v.numpy() for k, v in sd.items()}
    vcfg = jvae.infer_hunyuan_vae_config(sd_np, scaling_factor=1.0)
    vparams = jvae.convert_diffusers_hunyuan_vae(sd_np, vcfg)
    vae = jvae.HunyuanVAE(vcfg)

    def loss(tr, fr, mi, target, lmask):
        out = jpipe.model.apply(merge_params(tr, fr), **mi)
        return jpipe.loss_fn(out, target, lmask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(tr, fr, vp):
        mi, target, lmask = jpipe.prepare_inputs(KEY, jbatch)
        (l, out), grads = jax.value_and_grad(loss, has_aux=True)(tr, fr, mi, target, lmask)
        p = merge_params(tr, fr)["params"]
        ids = jnp.stack(jnp.meshgrid(*[jnp.arange(n) for n in GRID], indexing="ij"),
                        -1).reshape(-1, 3)
        cos, sin = jax_rope(ids, cfg.rope_axes_dim, cfg.rope_theta)
        (d_img, d_txt), _ = jhv.HunyuanDoubleBlock(cfg).apply(
            {"params": jax.tree.map(lambda a: a[0], p["double_blocks"])},
            (bi["img"], bi["txt"]), bi["vec"], cos, sin, bi["mask"])
        z = vae.apply(vp, clip, method=type(vae).encode)
        return dict(loss=l, out=out, grads=grads, double_img=d_img, double_txt=d_txt,
                    x=mi["x"], t=mi["t"], target=target, lmask=lmask, vae_latents=z)

    res = jax.tree.map(np.asarray, run(trainable, frozen, vparams))
    return dict(jpipe=jpipe, params=jax.tree.map(np.asarray, params), trainable=trainable,
                batch=batch, bi=bi, res=res, vae_sd=sd, vae_clip=clip, vae_cfg=vcfg)


def port_pipeline(ref):
    """The port's pipeline on the JAX weights (interop config and state)."""
    pipe = get_model_class("hunyuan_video_15")(CFG, device="cpu")
    want = hunyuan_video_15_config(ref["jpipe"].hv15_config)
    assert pipe.hv15_config == want
    pipe.model = HunyuanVideo15Transformer(want)
    pipe.model.load_state_dict(hunyuan_video_15_state_dict(ref["params"], want))
    return pipe


def test_config_is_the_jax_tiny_and_the_published_reading():
    """The port's `_tiny` config is the JAX one through interop; the
    published defaults are the 8.3 B reading (54 double blocks of 2,048, 16
    heads of 128, patch (1, 1, 1), 65 input channels, Qwen 3,584, RoPE (16,
    56, 56) at theta 256, 2 refiner blocks, no single block)."""
    c = get_model_class("hunyuan_video_1.5")({"model": {"type": "hunyuan_video_1.5"}},
                                             device="cpu")
    cfg = c.hv15_config
    assert (cfg.num_layers, cfg.num_single_layers, cfg.hidden_size, cfg.attention_head_dim,
            cfg.patch_size, cfg.in_channels, cfg.out_channels, cfg.text_dim,
            cfg.rope_axes_dim, cfg.rope_theta, cfg.refiner_layers) == (
        54, 0, 2048, 128, (1, 1, 1), 65, 32, 3584, (16, 56, 56), 256.0, 2)
    n = sum(p.numel() for p in c.model.parameters())
    assert round(n / 1e9, 1) == 8.3, n


def test_prepare_inputs_matches():
    """The input [x_t, zero latents, zero mask], the target, t x 1,000 and the
    loss mask from the JAX key's noise and t."""
    ref = reference()
    pipe = port_pipeline(ref)
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    noise, t = jax_draws(ref["jpipe"], KEY, ref["batch"])
    inputs, target, mask = pipe.prepare_inputs(batch, noise=noise, t=t)
    res = ref["res"]
    assert inputs["x"].shape == (2, 9, 3, 8, 8) and not inputs["x"][:, 4:].any()
    np.testing.assert_allclose(inputs["x"].numpy(), res["x"], atol=1e-6)
    np.testing.assert_allclose(target.numpy(), res["target"], atol=1e-6)
    np.testing.assert_allclose(inputs["t"].numpy(), res["t"], rtol=1e-6)
    np.testing.assert_array_equal(mask.expand(-1, 4, 3, -1, -1).numpy(),
                                  np.broadcast_to(res["lmask"], target.shape))


def test_double_block_matches():
    """The first double block on the [byT5, text] carry under its joint key
    mask against the JAX block (rel L2 1e-4)."""
    ref = reference()
    pipe = port_pipeline(ref)
    bi = {k: torch.from_numpy(v) for k, v in ref["bi"].items()}
    cfg = pipe.hv15_config
    ids = torch.stack(torch.meshgrid(*[torch.arange(n) for n in GRID], indexing="ij"),
                      -1).reshape(-1, 3)
    cos, sin = rope_frequencies(ids, cfg.rope_axes_dim, cfg.rope_theta)
    kv = torch.cat([torch.ones((2, 48), dtype=torch.int32), bi["mask"]], 1)
    with torch.no_grad():
        img, txt = pipe.model.double_blocks[0](bi["img"], bi["txt"], bi["vec"], cos, sin, kv)
    assert rel_l2(img.numpy(), ref["res"]["double_img"]) < 1e-4
    assert rel_l2(txt.numpy(), ref["res"]["double_txt"]) < 1e-4


def test_forward_and_lora_grads_match():
    """The whole module (the JAX form through interop) from the JAX noise and
    t: output, loss and every LoRA gradient."""
    ref = reference()
    pipe = port_pipeline(ref)
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    noise, t = jax_draws(ref["jpipe"], KEY, ref["batch"])
    inputs, target, mask = pipe.prepare_inputs(batch, noise=noise, t=t)
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(n))
    out = pipe.forward(inputs)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    res = ref["res"]
    assert rel_l2(out.detach().numpy(), res["out"]) < 1e-4
    np.testing.assert_allclose(loss.item(), float(res["loss"]), rtol=1e-5)
    want = hunyuan_video_15_state_dict(res["grads"], pipe.hv15_config)
    factors = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    # a double block's 10 adapted linears, 2 blocks
    assert set(factors) == set(want) and len(want) == 2 * 2 * 10
    for n, g in want.items():
        np.testing.assert_allclose(factors[n].grad.numpy(), g.numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=n)


def _raw_weights(ref, cfg):
    """The port's names of the JAX tree with final_linear's rows as the
    checkpoint holds them (read as it is, no reorder)."""
    raw = jax_to_state_dict(ref["params"])
    out = hunyuan_video_15_state_dict(ref["params"], cfg)
    out.update({k: raw[k] for k in ("final_linear.weight", "final_linear.bias")})
    return {k: v for k, v in out.items() if "lora" not in k}


def test_keymap_load_export_reimport(tmp_path):
    """The KeyMap writes the JAX keymap_from_flax's names and tensors; a
    `diffusion_model.`-prefixed file with a vision_in tower loads bit for
    bit, raises on a missing and on an untaken key, and its vision_in.*
    tensors come out of a full export; the LoRA goes out with the JAX
    export's keys and tensors and comes back bit for bit."""
    ref = reference()
    pipe = port_pipeline(ref)
    jpipe = ref["jpipe"]
    frozen = partition_params(ref["params"], jax_lora)[1]
    jsd = jkm.keymap_from_flax(frozen, jpipe.keymap(), jpipe.hv15_config)
    weights = _raw_weights(ref, pipe.hv15_config)
    out = tkm.keymap_from_state_dict(weights, pipe.keymap(), pipe.hv15_config)
    assert set(out) == set(jsd)
    for k, v in jsd.items():
        assert torch.equal(out[k], torch.from_numpy(np.ascontiguousarray(v))), k
    vision = {"vision_in.proj.0.weight": torch.arange(6.0).reshape(2, 3),
              "vision_in.proj.0.bias": torch.ones(2)}
    path = tmp_path / "hv15.safetensors"
    safetensors_io.save_file({"diffusion_model." + k: v for k, v in {**out, **vision}.items()},
                             str(path))
    mcfg = dict(CFG, model=dict(CFG["model"], transformer_path=str(path)))
    loader = get_model_class("hunyuan_video_15")(mcfg, device="cpu")
    loaded = loader.load_weights()
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k])
                                               for k in loaded)
    loader.model = HunyuanVideo15Transformer(loader.hv15_config)
    loader.model.load_state_dict(loaded, strict=False)
    loader.save_model(tmp_path / "full", loader.model)
    full = safetensors_io.load_file(tmp_path / "full" / "model.safetensors")
    assert set(full) == set(out) | set(vision)
    assert all(torch.equal(full[k], v) for k, v in vision.items())
    for name, bad, match in (
            ("missing", {k: v for k, v in out.items() if k != "cond_type_embedding.weight"},
             "cond_type_embedding.weight"),
            ("untaken", {**out, "double_blocks.0.img_attn.x.weight": torch.zeros(1)},
             "img_attn.x")):
        p = tmp_path / f"{name}.safetensors"
        safetensors_io.save_file(bad, str(p))
        with pytest.raises(KeyError, match=match):
            get_model_class("hunyuan_video_15")(
                dict(CFG, model=dict(CFG["model"], transformer_path=str(p))),
                device="cpu").load_weights()

    factors = {k: v.detach() for k, v in pipe.model.state_dict().items() if lora_predicate(k)}
    pipe.save_adapter(tmp_path / "adapter", factors)
    saved = safetensors_io.load_file(tmp_path / "adapter" / "adapter_model.safetensors")
    jax_export = jkm.export_lora_keymap(ref["trainable"], jpipe.keymap(), jpipe.hv15_config)
    assert {k for k in saved if not k.endswith(".alpha")} == set(jax_export)
    for k, v in jax_export.items():
        assert torch.equal(saved[k], torch.from_numpy(np.ascontiguousarray(v))), k
    back = pipe.load_adapter(tmp_path / "adapter")
    assert set(back) == set(factors) and all(torch.equal(back[k], factors[k]) for k in back)


def test_layout_comes_from_the_checkpoint(tmp_path):
    """load_weights rebuilds the model on the keys' layout (1 double block, 2
    refiner blocks, 3 heads of 16, patch (1, 1, 1), 7 input and 3 output
    channels, text 20, byT5 12 through 20) and loads it bit for bit; a
    [model] depth that disagrees raises."""
    pipe = get_model_class("hunyuan_video_15")(CFG, device="cpu")
    layout = dict(num_layers=1, refiner_layers=2, num_attention_heads=3, attention_head_dim=16,
                  patch_size=(1, 1, 1), in_channels=7, out_channels=3, text_dim=20,
                  byt5_dim=12, byt5_mapper_dim=20)
    cfg = dataclasses.replace(pipe.hv15_config, **layout)
    src = HunyuanVideo15Transformer(cfg)
    init_module_weights(src, torch.Generator().manual_seed(3))
    weights = {k: v for k, v in src.state_dict().items() if not lora_predicate(k)}
    path = tmp_path / "model.safetensors"
    safetensors_io.save_file(
        tkm.keymap_from_state_dict(weights, thv15.hunyuan_video_15_keymap(cfg), cfg), str(path))
    mc = dict(CFG["model"], transformer_path=str(path))
    pipe = get_model_class("hunyuan_video_15")(dict(CFG, model=mc), device="cpu")
    loaded = pipe.load_weights()
    assert all(getattr(pipe.hv15_config, k) == v for k, v in layout.items())
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k]) for k in loaded)
    with pytest.raises(KeyError, match="num_layers"):
        get_model_class("hunyuan_video_15")(dict(CFG, model=dict(mc, num_layers=2)),
                                            device="cpu").load_weights()


def test_vae_config_and_jax_form_encode(tmp_path):
    """The synthetic HunyuanVideo-1.5-shaped VAE checkpoint: the port reads
    the JAX infer_hunyuan_vae_config's topology from it (32 latent channels,
    five blocks, 4x in time, scaling 1.0); its JAX form encodes the clip as
    the JAX module does (rel L2 1e-4); the pipeline's VAE (the published
    form, from model.vae_path) gives [1, 32, 2, 2, 2] latents."""
    ref = reference()
    jcfg = ref["vae_cfg"]
    got = tvae.infer_hunyuan_vae_config(ref["vae_sd"], 2, scaling_factor=1.0)
    assert (got.latent_channels, got.block_out_channels, got.layers_per_block,
            got.temporal_downsamples, got.scaling_factor, got.quant_convs) == (
        jcfg.latent_channels, tuple(jcfg.block_out_channels), jcfg.layers_per_block,
        jcfg.temporal_downsamples, jcfg.scaling_factor, False) == (
        32, (8, 16, 16, 16, 16), 1, 2, 1.0, False)
    form = hunyuan_vae_config(jcfg)
    vae = tvae.HunyuanVAE(form)
    vae.load_state_dict(tvae.convert_hunyuan_vae(ref["vae_sd"], form))
    with torch.no_grad():
        z = vae.eval().encode(torch.from_numpy(ref["vae_clip"]))
    assert z.shape == ref["res"]["vae_latents"].shape == (1, 32, 2, 2, 2)
    assert rel_l2(z.numpy(), ref["res"]["vae_latents"]) < 1e-4
    path = tmp_path / "vae.safetensors"
    safetensors_io.save_file({"vae." + k: v for k, v in ref["vae_sd"].items()}, str(path))
    pipe = get_model_class("hunyuan_video_15")(
        {"model": {"type": "hunyuan_video_15", "dtype": "float32", "vae_path": str(path)}},
        device="cpu")
    latents = pipe.get_call_vae_fn()(ref["vae_clip"])["latents"]
    assert latents.shape == (1, 32, 2, 2, 2) and torch.isfinite(latents).all()
