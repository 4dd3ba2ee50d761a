"""The Lumina 2 family in the port (Lumina-Image-2.0, Z-Image, OmniGen2) vs
the JAX package.

The `_tiny` config (2 main blocks, 1 + 1 refiners, 4 heads of 12 over 2 kv
heads, caption 32 wide, f32) with LoRA (or LoKr) rank 4, LoRA B nonzero.
Seeded numpy weights on the JAX parameter structure
(tests/torch_port_helpers.py) cross through interop.lumina2_state_dict.
One jit a family gives the JAX prepare_inputs' noise and t, the output,
the loss (with a loss mask and a caption mask) and every adapter gradient.
Tolerances (f32): output 1e-4, loss 1e-5 relative, adapter gradients 1e-4
abs / 1e-3 rel (f32 sums in another order).

The port's Lumina 2 embeds the raw t (time_scale 1, as NextDiT does) where
the JAX module multiplies t by 1,000: it is held against the whole JAX
module fed t / 1000, which gives the same embedding to f32 rounding, and
with time_scale 1,000 (the port's Z-Image and OmniGen2) against the JAX
module as it is, fed t. Z-Image runs on a latent of 15 tokens, which the
learned pad token fills to 32, with RoPE offset 1. The sampler's first
Euler step from the JAX noise matches the JAX sampler's.

Exact: the NextDiT KeyMap (the fused attention.qkv of unequal q / k / v
rows), Z-Image's pad tokens and OmniGen2's diffusers names against the JAX
keymap_from_flax, both ways; load_weights of a `diffusion_model.`-prefixed
file; the adapter export (the JAX export's tensors, plus the refiners'
fused qkv, which the JAX export skips) and its re-import; each layout read
from a checkpoint's keys, and a [model] size that disagrees raising.

Where the port departs from the JAX package: Z-Image's published RoPE
(axes (32, 48, 48) at theta 256) against a table written by hand, the JAX
module failing at head dim 128 with the axes its Z-Image keeps, and
Z-Image's published defaults against the JAX ones.
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
from diffusion_pipe_tpu.models import lumina_2 as jlumina
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import lumina2_config, lumina2_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models.layers import init_module_weights, rope_frequencies
from diffusion_pipe_tpu_torch.models.lumina_2 import (Lumina2Config, Lumina2Transformer,
                                                      lumina2_rope_ids, nextdit_keymap)
from diffusion_pipe_tpu_torch.models.omnigen2 import omnigen2_keymap
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, jax_draws, random_params

KEY = jax.random.PRNGKey(8)
NAMES = {"lumina_2": ("cap_feats", "cap_mask"), "z_image": ("text_embeds_0", "attention_mask_0"),
         "omnigen2": ("prompt_embeds", "prompt_attention_mask")}


def lumina_cfg(family="lumina_2", adapter="lora", **model):
    return {"save_every_n_epochs": 1,
            "model": {"type": family, "dtype": "float32", "_tiny": True, **model},
            "adapter": {"type": adapter, "rank": 4, "alpha": 4, "dropout": 0.0},
            "optimizer": {"type": "adamw", "lr": 1e-3}}


def lumina_batch(family, hw=(8, 12), seed=21):
    """Latents, 8 caption rows (5 and 8 valid) under the family's names and
    a loss mask."""
    rng = np.random.default_rng(seed)
    feats, mask = NAMES[family]
    cap_mask = np.ones((2, 8), np.int32)
    cap_mask[0, 5:] = 0
    return {"latents": (rng.standard_normal((2, 16, *hw)) * 0.5).astype(np.float32),
            feats: rng.standard_normal((2, 8, 32)).astype(np.float32), mask: cap_mask,
            "mask": (rng.random((2, 12, 20)) > 0.5).astype(np.float32)}


# reference name -> (family, adapter, latent grid, divisors of the JAX t)
REFERENCES = {"lora": ("lumina_2", "lora", (8, 12), (1000.0, 1.0)),
              "lokr": ("lumina_2", "lokr", (8, 12), (1000.0,)),
              "z_image": ("z_image", "lora", (6, 10), (1.0,))}


@functools.lru_cache(maxsize=None)
def reference(name):
    """The JAX module's output, loss and adapter gradients, fed t / div for
    each divisor, from one jit (with the LoRA case, the sampler's first
    step)."""
    family, adapter, hw, divs = REFERENCES[name]
    jpipe = jax_model_class(family)(lumina_cfg(family, adapter))
    params = random_params(jpipe, seed=7, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    batch = lumina_batch(family, hw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    feats, mask = NAMES[family]

    def loss_fn(tr, div):
        mi, target, lmask = jpipe.prepare_inputs(KEY, jbatch)
        out = jpipe.model.apply(merge_params(tr, frozen), **dict(mi, t=mi["t"] / div))
        return jpipe.loss_fn(out, target, lmask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(tr, full):
        res = {div: jax.value_and_grad(loss_fn, has_aux=True)(tr, div) for div in divs}
        sample = None
        if name == "lora":
            sample = jpipe.sample(full, 16, 32, KEY, num_steps=1, cap_feats=jbatch[feats],
                                  cap_mask=jbatch[mask])
        return res, sample, jax.random.normal(KEY, (2, 16, 4, 2), jnp.float32)

    res, sample, noise = run(trainable, params)
    out = {div: dict(loss=float(loss), out=np.asarray(o),
                     grads=lumina2_state_dict(jax.tree.map(np.asarray, g)))
           for div, ((loss, o), g) in res.items()}
    return dict(jpipe=jpipe, params=jax.tree.map(np.asarray, params), batch=batch, runs=out,
                sample=None if sample is None else np.asarray(sample),
                sample_noise=np.asarray(noise))


def port_pipeline(ref, family, adapter="lora", **over):
    pipe = get_model_class(family)(lumina_cfg(family, adapter), device="cpu")
    assert pipe.lumina_config == lumina2_config(ref["jpipe"].lumina_config,
                                                time_scale=pipe.lumina_config.time_scale)
    if over:
        pipe.lumina_config = dataclasses.replace(pipe.lumina_config, **over)
        pipe.model = Lumina2Transformer(pipe.lumina_config)
    pipe.model.to_empty(device="cpu")
    pipe.model.load_state_dict(lumina2_state_dict(ref["params"]))
    return pipe


# case -> (reference, family of the port's pipeline, JAX t divisor, port overrides)
CASES = {"lumina2_lora_t_over_1000": ("lora", "lumina_2", 1000.0, {}),
         "lumina2_lora_remat_full": ("lora", "lumina_2", 1000.0, {"remat": "full"}),
         "lumina2_time_scale_1000": ("lora", "lumina_2", 1.0, {"time_scale": 1000.0}),
         "omnigen2_lora": ("lora", "omnigen2", 1.0, {}),
         "lumina2_lokr_t_over_1000": ("lokr", "lumina_2", 1000.0, {}),
         "z_image_pad_tokens": ("z_image", "z_image", 1.0, {})}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_adapter_grads_match(case):
    """The whole module: output, loss (masked) and every adapter gradient.
    OmniGen2's tiny module is the JAX Lumina 2 module at time_scale 1,000."""
    name, family, div, over = CASES[case]
    ref = reference(name)
    adapter = REFERENCES[name][1]
    pipe = port_pipeline(ref, family, adapter, **over)
    want = ref["runs"][div]
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    (f, m), (pf, pm) = NAMES[REFERENCES[name][0]], pipe.text_keys
    batch[pf], batch[pm] = batch.pop(f), batch.pop(m)
    noise, t = jax_draws(ref["jpipe"], KEY, ref["batch"])
    inputs, target, mask = pipe.prepare_inputs(batch, noise=noise, t=t)
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(n))
    out = pipe.forward(inputs)
    np.testing.assert_allclose(out.detach().numpy(), want["out"], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    factors = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    per_linear = 2 if adapter == "lora" else 3  # LoKr: w1, w2_a, w2_b
    assert set(factors) == set(want["grads"]) and len(factors) == 4 * 7 * per_linear
    for n, p in factors.items():
        np.testing.assert_allclose(p.grad.numpy(), want["grads"][n].numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=n)
    if name == "z_image":
        assert pipe.lumina_config.rope_cap_offset == 1
        _, img_ids, pads = lumina2_rope_ids(pipe.lumina_config, 8, 3, 5)
        assert pads == 17 and img_ids.shape == (32, 3) and img_ids[15:].eq(0).all()


def test_sampler_first_step_matches_jax():
    """One Euler step from the JAX noise: the negated model output at 1 - t
    (time_scale 1,000, the JAX module's)."""
    ref = reference("lora")
    pipe = port_pipeline(ref, "lumina_2", time_scale=1000.0)
    b = ref["batch"]
    got = pipe.sample(width=16, height=32, noise=torch.tensor(ref["sample_noise"]),
                      num_steps=1, cap_feats=torch.from_numpy(b["cap_feats"]),
                      cap_mask=torch.from_numpy(b["cap_mask"]))
    np.testing.assert_allclose(got.numpy(), ref["sample"], atol=1e-4, rtol=1e-4)


def _jax_checkpoint(ref, family):
    """The JAX keymap_from_flax of the reference weights (no adapter)."""
    jpipe = jax_model_class(family)(lumina_cfg(family))
    params = ref["params"] if family != "z_image" else reference("z_image")["params"]
    frozen = partition_params(params, jax_lora)[1]
    return jpipe, params, jkm.keymap_from_flax(frozen, jpipe.keymap(), jpipe.lumina_config)


@pytest.mark.parametrize("family", ["lumina_2", "z_image", "omnigen2"])
def test_keymap_matches_jax_both_ways(family):
    """The port's KeyMap writes the JAX keymap_from_flax's names and tensors
    (NextDiT's fused qkv of 48 / 24 / 24 rows, Z-Image's pad tokens,
    OmniGen2's diffusers names) and reads them back."""
    _, params, sd = _jax_checkpoint(reference("lora"), family)
    pipe = get_model_class(family)(lumina_cfg(family), device="cpu")
    weights = {k: v for k, v in lumina2_state_dict(params).items() if "lora" not in k}
    out = tkm.keymap_from_state_dict(weights, pipe.keymap(), pipe.lumina_config)
    assert set(out) == set(sd)
    for k, v in sd.items():
        assert torch.equal(out[k], torch.from_numpy(np.ascontiguousarray(v))), k
    back = tkm.keymap_to_state_dict(out, pipe.keymap(), pipe.lumina_config)
    assert set(back) == set(weights) and all(torch.equal(back[k], weights[k]) for k in back)
    if family == "lumina_2":
        assert sd["layers.0.attention.qkv.weight"].shape == (48 + 24 + 24, 48)
    elif family == "z_image":
        assert sd["x_pad_token"].shape == (1, 48) and "cap_pad_token" in sd
    else:
        assert "layers.1.attn.to_k.weight" in sd and "noise_refiner.0.norm1.linear.weight" in sd
        assert "context_refiner.0.norm1.weight" in sd


def test_unequal_fused_qkv_load_export_reimport(tmp_path):
    """A `diffusion_model.`-prefixed NextDiT file loads bit for bit; the
    adapter goes out with each fused qkv as one pair of rank 12 over its 96
    rows (A the three parts' A, B block-diagonal), the JAX export's tensors
    where it writes them, and the refiners' qkv too, which the JAX export
    skips; it comes back bit for bit."""
    ref = reference("lora")
    jpipe, params, sd = _jax_checkpoint(ref, "lumina_2")
    safetensors_io.save_file({"diffusion_model." + k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in sd.items()}, str(tmp_path / "lumina2.safetensors"))
    pipe = get_model_class("lumina_2")(
        lumina_cfg(transformer_path=str(tmp_path / "lumina2.safetensors")), device="cpu")
    loaded = pipe.load_weights()
    weights = lumina2_state_dict(params)
    assert set(loaded) == {k for k in weights if "lora" not in k}
    assert all(torch.equal(loaded[k], weights[k]) for k in loaded)

    factors = {k: v for k, v in weights.items() if lora_predicate(k)}
    pipe.save_adapter(tmp_path / "adapter", factors)
    saved = safetensors_io.load_file(tmp_path / "adapter" / "adapter_model.safetensors")
    a, b = (saved[f"diffusion_model.layers.0.attention.qkv.lora_{x}.weight"] for x in "AB")
    assert a.shape == (12, 48) and b.shape == (96, 12)
    assert not b[:48, 4:].any() and not b[48:72, :4].any() and not b[48:72, 8:].any()
    jax_export = jkm.export_lora_keymap(partition_params(params, jax_lora)[0], jpipe.keymap(),
                                        jpipe.lumina_config)
    pairs = {k for k in saved if k.endswith(".lora_A.weight")}
    skipped = {f"diffusion_model.{g}.0.attention.qkv.lora_A.weight"
               for g in ("context_refiner", "noise_refiner")}
    assert pairs - {k for k in jax_export if k.endswith(".lora_A.weight")} == skipped
    assert len(pairs) == 4 * 5
    for k, v in jax_export.items():
        assert torch.equal(saved[k], torch.from_numpy(np.ascontiguousarray(v))), k
    back = pipe.load_adapter(tmp_path / "adapter")
    assert set(back) == set(factors) and all(torch.equal(back[k], factors[k]) for k in back)


# a layout unlike the tiny one in every field the keys give: 3 heads of 12
# over 1 kv head, 3 main blocks and 2 + 2 refiners, a 24-wide caption, a
# 20-wide timestep embedding from a 28-wide MLP, a 50-wide SwiGLU
LAYOUT = dict(dim=36, num_heads=3, num_kv_heads=1, num_layers=3, num_refiner_layers=2,
              cap_dim=24, adaln_dim=20, time_mid_dim=28, ffn_hidden_dim=50)


@pytest.mark.parametrize("family", ["lumina_2", "z_image", "omnigen2"])
def test_layout_comes_from_the_checkpoint(family, tmp_path):
    """load_weights rebuilds the model on the layout of the checkpoint's
    keys (Lumina 2's kv heads from the fused qkv's rows, OmniGen2's from
    to_k's, Z-Image's pad tokens) and loads it bit for bit; a [model] size
    that disagrees with the keys raises, naming it."""
    pipe = get_model_class(family)(lumina_cfg(family), device="cpu")
    cfg = dataclasses.replace(pipe.lumina_config, **LAYOUT)
    src = Lumina2Transformer(cfg)
    init_module_weights(src, torch.Generator().manual_seed(3))
    weights = {k: v for k, v in src.state_dict().items() if "lora" not in k}
    km = omnigen2_keymap(cfg) if family == "omnigen2" else nextdit_keymap(cfg)
    sd = tkm.keymap_from_state_dict(weights, km, cfg)
    path = tmp_path / "model.safetensors"
    safetensors_io.save_file(sd, str(path))
    pipe = get_model_class(family)(lumina_cfg(family, transformer_path=str(path)), device="cpu")
    loaded = pipe.load_weights()
    assert all(getattr(pipe.lumina_config, k) == v for k, v in LAYOUT.items())
    assert (pipe.lumina_config.pad_tokens_multiple == 32) == (family == "z_image")
    pipe.model.to_empty(device="cpu")
    pipe.model.load_state_dict(loaded, strict=False)
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k]) for k in loaded)
    with pytest.raises(KeyError, match="num_layers"):
        get_model_class(family)(lumina_cfg(family, transformer_path=str(path), num_layers=2),
                                device="cpu").load_weights()
    if family == "z_image":
        with pytest.raises(KeyError, match="x_pad_token"):
            get_model_class(family)(lumina_cfg(family, transformer_path=str(path),
                                               pad_tokens_multiple=0), device="cpu").load_weights()


def test_zimage_rope_matches_a_hand_table():
    """Z-Image's published RoPE: axes (32, 48, 48) at theta 256 over the head
    dim of 128; caption row i at (i + 1, 0, 0), the image tokens at
    (cap_len + 1, row, col), the pads at (0, 0, 0)."""
    pipe = get_model_class("z_image")({"model": {"type": "z_image"}}, device="cpu")
    cfg = pipe.lumina_config
    assert (cfg.axes_dims_rope, cfg.rope_theta, cfg.head_dim) == ((32, 48, 48), 256.0, 128)
    cap_ids, img_ids, pads = lumina2_rope_ids(cfg, 3, 2, 3)
    assert pads == 26
    ids = torch.cat([cap_ids, img_ids])
    want_ids = [(1, 0, 0), (2, 0, 0), (3, 0, 0), (4, 0, 0), (4, 0, 1), (4, 0, 2), (4, 1, 0),
                (4, 1, 1), (4, 1, 2)] + [(0, 0, 0)] * 26
    assert ids.tolist() == [list(i) for i in want_ids]
    cos, sin = rope_frequencies(ids, cfg.axes_dims_rope, cfg.rope_theta)
    assert cos.shape == (35, 64)
    for row, pos in enumerate(want_ids):
        angles = []
        for axis, d in enumerate((32, 48, 48)):
            for j in range(d // 2):
                angles.append(pos[axis] / 256.0 ** (2 * j / d))
        np.testing.assert_allclose(cos[row].numpy(), np.cos(angles), atol=1e-6)
        np.testing.assert_allclose(sin[row].numpy(), np.sin(angles), atol=1e-6)


def test_jax_zimage_rope_fails_at_head_dim_128():
    """The JAX Z-Image keeps Lumina's axes (32, 32, 32): a 48-wide table
    against a head dim of 128, so its model fails to build (the JAX tiny
    config's head dim of 12 hides it). The port raises at construction
    with those axes and builds with the published ones."""
    jcfg = jlumina.Lumina2Config(dim=256, num_heads=2, num_kv_heads=2, num_layers=1,
                                 num_refiner_layers=1, cap_dim=32, dtype=jnp.float32,
                                 param_dtype=jnp.float32)
    jmodel = jlumina.Lumina2Transformer(jcfg)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 4, 4)),
                       jnp.zeros((1,)), jnp.zeros((1, 4, 32)), jnp.ones((1, 4), jnp.int32))
    port = Lumina2Config(dim=256, num_heads=2, num_kv_heads=2, num_layers=1,
                         num_refiner_layers=1, cap_dim=32)
    with pytest.raises(ValueError, match="head dim 128"):
        Lumina2Transformer(port)
    with torch.device("meta"):
        Lumina2Transformer(dataclasses.replace(port, axes_dims_rope=(32, 48, 48)))


def test_published_defaults():
    """Z-Image's published layout (3,840 wide, 30 + 2 + 2 blocks, 30 heads
    of 128 without grouping, Qwen3-4B's 2,560, adaLN 256 from a 1,024-wide
    MLP, t x 1,000) where the JAX defaults are 3,072 / 24 / 8; Lumina 2's
    (2,304, 24 heads of 96 over 8, t x 1) and OmniGen2's (2,520, 21 heads
    of 120 over 7, t x 1,000) as the JAX ones: 1.97 / 6.15 / 2.80 B
    parameters as the port builds them."""
    counts = {}
    for family in NAMES:
        pipe = get_model_class(family)({"model": {"type": family}}, device="cpu")
        jcfg = jax_model_class(family)({"model": {"type": family}}).lumina_config
        c = pipe.lumina_config
        counts[family] = sum(p.numel() for p in pipe.model.parameters())
        if family == "z_image":
            assert (c.dim, c.num_layers, c.num_heads, c.num_kv_heads, c.cap_dim) == (
                3840, 30, 30, 30, 2560)
            assert (c.adaln_width, c.time_mid_width, c.time_scale, c.head_dim) == (
                256, 1024, 1000.0, 128)
            assert (jcfg.dim, jcfg.num_heads, jcfg.num_kv_heads) == (3072, 24, 8)
        else:
            assert c == lumina2_config(jcfg, time_scale=c.time_scale,
                                       dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                       lora_dtype=c.lora_dtype)
            assert (c.head_dim, c.time_scale) == ((96, 1.0) if family == "lumina_2"
                                                  else (120, 1000.0))
    assert [round(counts[f] / 1e9, 2) for f in NAMES] == [1.97, 6.15, 2.80]
