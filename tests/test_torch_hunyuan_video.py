"""HunyuanVideo in the port vs the JAX package.

The `_tiny` config (2 + 2 blocks, 4 heads of 32, a 1-block refiner, text 32
wide, CLIP 16, RoPE (8, 12, 12), guidance on, f32) with LoRA rank 4, LoRA B
nonzero. Seeded numpy weights on the JAX parameter structure
(tests/torch_port_helpers.py) cross through interop.hunyuan_video_state_dict,
which reorders the head's rows from the JAX module's (pt, ph, pw, c) patch
order to hyvideo's (c, pt, ph, pw). The batch: latents of 3 x 8 x 8 (48
image tokens), 6 text rows of which example 0 has 4 valid and example 1
none (an empty caption: the refiner's attention has no valid key), CLIP
pooled, a loss mask.

One jit holds the JAX side, from the JAX prepare_inputs' noise and t: the
whole module's output, loss and LoRA gradients, and the refiner, the first
double and the first single block on the same inputs. Tolerances (f32):
rel L2 1e-4 on the outputs and blocks, losses 1e-5 relative, gradients 1e-4
abs / 1e-3 rel. The empty caption's text rows never reach the loss (masked
as keys, cut off before the head): only the image output is compared, and
it is finite.

Exact: the published unflattening against the JAX head on final_linear rows
permuted from (c, pt, ph, pw) to (pt, ph, pw, c); prepare_inputs'
x_t, target and t x 1,000 with guidance x 1,000; the KeyMap against the JAX
keymap_from_flax, load_weights raising on a missing and an untaken key, a
layout read from the keys, the LoRA export with the JAX export's keys and
tensors and its re-import; the templates against the JAX pipeline's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models import hunyuan_video_model as jhv
from diffusion_pipe_tpu.models import keymaps as jkm
from diffusion_pipe_tpu.models.layers import rope_frequencies as jax_rope
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import (hunyuan_video_config, hunyuan_video_state_dict,
                                              jax_to_state_dict)
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import hunyuan_video as thv
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models.hunyuan_video_model import (
    HunyuanDoubleBlock, HunyuanSingleBlock, HunyuanVideoTransformer, TokenRefinerBlock,
    text_rope_rows, unpatchify)
from diffusion_pipe_tpu_torch.models.layers import init_module_weights, rope_frequencies
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, jax_draws, random_params

KEY = jax.random.PRNGKey(18)
CFG = {"save_every_n_epochs": 1,
       "model": {"type": "hunyuan-video", "dtype": "float32", "_tiny": True},
       "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
       "optimizer": {"type": "adamw", "lr": 1e-3}}
GRID = (3, 4, 4)   # latent frames, and the 8 x 8 latents in 2 x 2 patches
TXT = 6


def hv_batch(seed=41):
    rng = np.random.default_rng(seed)
    mask = np.zeros((2, TXT), np.int32)
    mask[0, :4] = 1
    return {"latents": (rng.standard_normal((2, 16, 3, 8, 8)) * 0.5).astype(np.float32),
            "text_states": rng.standard_normal((2, TXT, 32)).astype(np.float32),
            "text_mask": mask,
            "clip_pooled": rng.standard_normal((2, 16)).astype(np.float32),
            "mask": (rng.random((2, 12, 20)) > 0.4).astype(np.float32)}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def block_inputs(cfg, seed=3):
    """Inputs of the block checks: image 48 rows, text 6 (4 valid), a
    conditioning vector, RoPE over GRID."""
    rng = np.random.default_rng(seed)
    dim = cfg.hidden_size
    mask = np.array([[1, 1, 1, 1, 0, 0]] * 2, np.int32)
    ids = np.stack(np.meshgrid(*[np.arange(n) for n in GRID], indexing="ij"), -1).reshape(-1, 3)
    return dict(img=rng.standard_normal((2, 48, dim)).astype(np.float32),
                txt=rng.standard_normal((2, TXT, dim)).astype(np.float32),
                vec=rng.standard_normal((2, dim)).astype(np.float32),
                mask=mask, ids=ids)


@functools.lru_cache(maxsize=None)
def reference():
    """The JAX pipeline, its weights, the batch and the JAX results (one
    jit): the module's loss, output and LoRA gradients; the refiner's,
    the first double block's and the first single block's outputs."""
    jpipe = jax_model_class("hunyuan-video")(CFG)
    params = random_params(jpipe, seed=12, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    batch = hv_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = jpipe.hv_config
    bi = block_inputs(cfg)

    def loss(tr, fr, mi, target, lmask):
        out = jpipe.model.apply(merge_params(tr, fr), **mi)
        return jpipe.loss_fn(out, target, lmask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(tr, fr):
        mi, target, lmask = jpipe.prepare_inputs(KEY, jbatch)
        (l, out), grads = jax.value_and_grad(loss, has_aux=True)(tr, fr, mi, target, lmask)
        p = merge_params(tr, fr)["params"]
        one = lambda stack: jax.tree.map(lambda a: a[0], p[stack])  # noqa: E731
        cos, sin = jax_rope(jnp.asarray(bi["ids"]), cfg.rope_axes_dim, cfg.rope_theta)
        refined = jhv.TokenRefinerBlock(cfg).apply({"params": p["refiner_0"]}, bi["txt"],
                                                   bi["vec"], bi["mask"])
        kv = jnp.concatenate([jnp.ones((2, 48), jnp.int32), bi["mask"]], 1)
        (d_img, d_txt), _ = jhv.HunyuanDoubleBlock(cfg).apply(
            {"params": one("double_blocks")}, (bi["img"], bi["txt"]), bi["vec"], cos, sin,
            bi["mask"])
        single, _ = jhv.HunyuanSingleBlock(cfg, 48).apply(
            {"params": one("single_blocks")}, jnp.concatenate([bi["img"], bi["txt"]], 1),
            bi["vec"], cos, sin, kv)
        return dict(loss=l, out=out, grads=grads, refiner=refined, double_img=d_img,
                    double_txt=d_txt, single=single, x=mi["x"], t=mi["t"],
                    guidance=mi["guidance"], target=target, lmask=lmask)

    res = jax.tree.map(np.asarray, run(trainable, frozen))
    return dict(jpipe=jpipe, params=jax.tree.map(np.asarray, params), trainable=trainable,
                batch=batch, bi=bi, res=res)


def port_pipeline(ref):
    """The port's pipeline on the JAX weights (interop config and state)."""
    pipe = get_model_class("hunyuan-video")(CFG, device="cpu")
    want = hunyuan_video_config(ref["jpipe"].hv_config)
    assert pipe.hv_config == want
    pipe.model = HunyuanVideoTransformer(want)
    pipe.model.load_state_dict(hunyuan_video_state_dict(ref["params"], want))
    return pipe


def test_config_is_the_jax_tiny_and_published_defaults():
    """The port's `_tiny` config is the JAX one through interop; the
    published defaults (20 + 40 blocks of 3,072, 24 heads of 128, RoPE (16,
    56, 56) at theta 256, 2 refiner blocks, guidance) are the JAX defaults,
    12.8 B parameters as the port builds them."""
    pipe = get_model_class("hunyuan_video")({"model": {"type": "hunyuan_video"}}, device="cpu")
    c = pipe.hv_config
    jcfg = jax_model_class("hunyuan-video")({"model": {"type": "hunyuan-video"}}).hv_config
    assert c == hunyuan_video_config(jcfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                     lora_dtype=c.lora_dtype)
    assert (c.num_layers, c.num_single_layers, c.hidden_size, c.attention_head_dim,
            c.refiner_layers, c.rope_axes_dim, c.rope_theta) == (20, 40, 3072, 128, 2,
                                                                 (16, 56, 56), 256.0)
    n = sum(p.numel() for p in pipe.model.parameters())
    assert round(n / 1e9, 1) == 12.8, n


def test_prepare_inputs_matches():
    """x_t, the target, t x 1,000, guidance x 1,000 and the loss mask from
    the JAX key's noise and t."""
    ref = reference()
    pipe = port_pipeline(ref)
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    noise, t = jax_draws(ref["jpipe"], KEY, ref["batch"])
    inputs, target, mask = pipe.prepare_inputs(batch, noise=noise, t=t)
    res = ref["res"]
    np.testing.assert_allclose(inputs["x"].numpy(), res["x"], atol=1e-6)
    np.testing.assert_allclose(target.numpy(), res["target"], atol=1e-6)
    np.testing.assert_allclose(inputs["t"].numpy(), res["t"], rtol=1e-6)
    np.testing.assert_array_equal(inputs["guidance"].numpy(), res["guidance"])
    assert res["guidance"].tolist() == [1000.0, 1000.0]
    np.testing.assert_array_equal(mask.expand(-1, 16, 3, -1, -1).numpy(),
                                  np.broadcast_to(res["lmask"], target.shape))


@pytest.mark.parametrize("block", ["refiner", "double", "single"])
def test_blocks_match(block):
    """The refiner, the first double and the first single block against the
    JAX modules on the same weights and inputs (rel L2 1e-4)."""
    ref = reference()
    pipe = port_pipeline(ref)
    bi = {k: torch.from_numpy(v) for k, v in ref["bi"].items()}
    cfg = pipe.hv_config
    cos, sin = rope_frequencies(bi["ids"], cfg.rope_axes_dim, cfg.rope_theta)
    kv = torch.cat([torch.ones((2, 48), dtype=torch.int32), bi["mask"]], 1)
    res = ref["res"]
    with torch.no_grad():
        if block == "refiner":
            got = {"refiner": pipe.model.refiner[0](bi["txt"], bi["vec"], bi["mask"])}
            assert isinstance(pipe.model.refiner[0], TokenRefinerBlock)
        elif block == "double":
            img, txt = pipe.model.double_blocks[0](bi["img"], bi["txt"], bi["vec"], cos, sin, kv)
            got = {"double_img": img, "double_txt": txt}
            assert isinstance(pipe.model.double_blocks[0], HunyuanDoubleBlock)
        else:
            c2, s2 = text_rope_rows(cos, sin, TXT)
            got = {"single": pipe.model.single_blocks[0](torch.cat([bi["img"], bi["txt"]], 1),
                                                         bi["vec"], c2, s2, kv)}
            assert isinstance(pipe.model.single_blocks[0], HunyuanSingleBlock)
    for k, v in got.items():
        assert rel_l2(v.numpy(), res[k]) < 1e-4, k


def test_forward_and_lora_grads_match():
    """The whole module (the JAX form through interop) from the JAX noise and
    t: output, loss and every LoRA gradient; the empty caption's example is
    finite."""
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
    assert torch.isfinite(out).all()
    assert rel_l2(out.detach().numpy(), res["out"]) < 1e-4
    np.testing.assert_allclose(loss.item(), float(res["loss"]), rtol=1e-5)
    want = hunyuan_video_state_dict(res["grads"], pipe.hv_config)
    factors = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    # a double block's 10 adapted linears and a single block's 3, 2 + 2 blocks
    assert set(factors) == set(want) and len(want) == 2 * (2 * 10 + 2 * 3)
    for n, g in want.items():
        np.testing.assert_allclose(factors[n].grad.numpy(), g.numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=n)


def test_unflatten_is_hyvideos():
    """The port's head reads final_linear's rows as (c, pt, ph, pw)
    (hyvideo's unpatchify): it equals the JAX module's einsum over rows
    permuted to (pt, ph, pw, c), exactly."""
    rng = np.random.default_rng(5)
    c, grid, patch = 3, (2, 3, 2), (1, 2, 2)
    out = torch.from_numpy(rng.standard_normal((2, 12, c * 4)).astype(np.float32))
    got = unpatchify(out, c, grid, patch)
    # the JAX head on the same rows reordered (c, p) -> (p, c)
    jrows = out.reshape(2, 12, c, 4).transpose(2, 3).reshape(2, 12, -1).numpy()
    x = jrows.reshape(2, *grid, *patch, c)
    want = np.einsum("bfhwpqrc->bcfphqwr", x).reshape(2, c, 2, 6, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    # diffusers' permute (0, 4, 1, 5, 2, 6, 3, 7) of the (c, p) layout
    d = out.reshape(2, *grid, c, *patch).permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(2, c, 2, 6, 4)
    assert torch.equal(got, d)


def _jax_checkpoint(ref):
    jpipe = ref["jpipe"]
    frozen = partition_params(ref["params"], jax_lora)[1]
    return jkm.keymap_from_flax(frozen, jpipe.keymap(), jpipe.hv_config)


def _raw_weights(ref, cfg):
    """The port's names of the JAX tree with final_linear's rows as the
    checkpoint holds them (no reorder: a hyvideo file is read as it is)."""
    raw = jax_to_state_dict(ref["params"])
    out = hunyuan_video_state_dict(ref["params"], cfg)
    out.update({k: raw[k] for k in ("final_linear.weight", "final_linear.bias")})
    return {k: v for k, v in out.items() if "lora" not in k}


def test_keymap_load_export_reimport(tmp_path):
    """The KeyMap writes the JAX keymap_from_flax's names and tensors and
    reads them back; a `transformer.`-prefixed file loads bit for bit and
    raises on a missing and on an untaken key; the LoRA goes out with the
    JAX export's keys and tensors and comes back bit for bit."""
    ref = reference()
    pipe = port_pipeline(ref)
    jsd = _jax_checkpoint(ref)
    weights = _raw_weights(ref, pipe.hv_config)
    out = tkm.keymap_from_state_dict(weights, pipe.keymap(), pipe.hv_config)
    assert set(out) == set(jsd)
    for k, v in jsd.items():
        assert torch.equal(out[k], torch.from_numpy(np.ascontiguousarray(v))), k
    path = tmp_path / "hv.safetensors"
    safetensors_io.save_file({"transformer." + k: v for k, v in out.items()}, str(path))
    mcfg = dict(CFG, model=dict(CFG["model"], transformer_path=str(path)))
    loaded = get_model_class("hunyuan-video")(mcfg, device="cpu").load_weights()
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k])
                                               for k in loaded)
    for name, bad, match in (
            ("missing", {k: v for k, v in out.items() if k != "guidance_in.mlp.2.weight"},
             "guidance_in.mlp.2.weight"),
            ("untaken", {**out, "double_blocks.0.img_attn_x.weight": torch.zeros(1)},
             "img_attn_x")):
        p = tmp_path / f"{name}.safetensors"
        safetensors_io.save_file(bad, str(p))
        with pytest.raises(KeyError, match=match):
            get_model_class("hunyuan-video")(
                dict(CFG, model=dict(CFG["model"], transformer_path=str(p))),
                device="cpu").load_weights()

    factors = {k: v.detach() for k, v in pipe.model.state_dict().items() if lora_predicate(k)}
    pipe.save_adapter(tmp_path / "adapter", factors)
    saved = safetensors_io.load_file(tmp_path / "adapter" / "adapter_model.safetensors")
    jpipe = ref["jpipe"]
    jax_export = jkm.export_lora_keymap(ref["trainable"], jpipe.keymap(), jpipe.hv_config)
    assert {k for k in saved if not k.endswith(".alpha")} == set(jax_export)
    for k, v in jax_export.items():
        assert torch.equal(saved[k], torch.from_numpy(np.ascontiguousarray(v))), k
    assert all(k.startswith("transformer.") for k in saved)
    back = pipe.load_adapter(tmp_path / "adapter")
    assert set(back) == set(factors) and all(torch.equal(back[k], factors[k]) for k in back)


def test_layout_comes_from_the_checkpoint(tmp_path):
    """load_weights rebuilds the model on the keys' layout (1 + 3 blocks, 2
    refiner blocks, 3 heads of 16, no guidance_in, text 20, CLIP 12) and
    loads it bit for bit; a [model] depth that disagrees raises."""
    pipe = get_model_class("hunyuan-video")(CFG, device="cpu")
    layout = dict(num_layers=1, num_single_layers=3, refiner_layers=2, num_attention_heads=3,
                  attention_head_dim=16, guidance_embeds=False, text_dim=20,
                  pooled_projection_dim=12, rope_axes_dim=(4, 6, 6))
    cfg = dataclasses.replace(pipe.hv_config, **layout)
    src = HunyuanVideoTransformer(cfg)
    init_module_weights(src, torch.Generator().manual_seed(3))
    weights = {k: v for k, v in src.state_dict().items() if not lora_predicate(k)}
    path = tmp_path / "model.safetensors"
    safetensors_io.save_file(tkm.keymap_from_state_dict(weights, thv.hunyuan_video_keymap(cfg),
                                                        cfg), str(path))
    mc = dict(CFG["model"], transformer_path=str(path))
    pipe = get_model_class("hunyuan-video")(dict(CFG, model=mc), device="cpu")
    loaded = pipe.load_weights()
    layout.pop("rope_axes_dim")
    assert all(getattr(pipe.hv_config, k) == v for k, v in layout.items())
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k]) for k in loaded)
    with pytest.raises(KeyError, match="num_single_layers"):
        get_model_class("hunyuan-video")(dict(CFG, model=dict(mc, num_single_layers=2)),
                                         device="cpu").load_weights()


def test_templates_match_the_jax_pipeline(monkeypatch):
    """The LLaVA templates, crops and hidden layer, text_len and the CLIP
    encoder's arguments are those the JAX pipeline hands its encoders."""
    from diffusion_pipe_tpu.models import llm_encoders as jllm
    from diffusion_pipe_tpu.models import text_encoders as jte

    seen = []

    class Record:
        def __init__(self, *args, **kw):
            seen.append((args, kw))

    monkeypatch.setattr(jllm, "LLMTextEncoder", Record)
    monkeypatch.setattr(jte, "HFTextEncoder", Record)
    for video in (True, False):
        mc = {"type": "hunyuan-video", "llm_path": "llm", "clip_path": "clip",
              "support_video": video}
        seen.clear()
        jax_model_class("hunyuan-video")({"model": mc}).get_call_text_encoder_fns()
        (_, llm_kw), (clip_args, clip_kw) = seen
        assert llm_kw["template"] == (thv.VIDEO_TEMPLATE if video else thv.IMAGE_TEMPLATE)
        assert llm_kw["crop_start"] == (95 if video else 36) == (
            thv.VIDEO_CROP_START if video else thv.IMAGE_CROP_START)
        assert (llm_kw["hidden_layer"], llm_kw["max_length"]) == (-3, 256)
        assert clip_args == ("clip_pooled", "clip") and clip_kw == {"max_length": 77}



LLAMA = dict(model_type="llama", vocab_size=64, hidden_size=32, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=2, intermediate_size=48,
             rope_theta=500000.0, rms_norm_eps=1e-5)


def _llama_checkpoint():
    """A LlamaForCausalLM state dict of LLAMA's shapes (transformers' names,
    seeded values): `model.layers.*`, `model.embed_tokens`, `model.norm`
    and `lm_head`."""
    gen = torch.Generator().manual_seed(1)
    d, kv, ff = 32, 16, 48
    shapes = {"embed_tokens.weight": (64, d), "norm.weight": (d,)}
    for i in range(3):
        shapes.update({f"layers.{i}.self_attn.q_proj.weight": (d, d),
                       f"layers.{i}.self_attn.k_proj.weight": (kv, d),
                       f"layers.{i}.self_attn.v_proj.weight": (kv, d),
                       f"layers.{i}.self_attn.o_proj.weight": (d, d),
                       f"layers.{i}.mlp.gate_proj.weight": (ff, d),
                       f"layers.{i}.mlp.up_proj.weight": (ff, d),
                       f"layers.{i}.mlp.down_proj.weight": (d, ff),
                       f"layers.{i}.input_layernorm.weight": (d,),
                       f"layers.{i}.post_attention_layernorm.weight": (d,)})
    sd = {"model." + k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    sd["lm_head.weight"] = torch.randn((64, d), generator=gen)
    return sd


@pytest.mark.parametrize("layout", ["model_with_lm_head", "bare"])
def test_llava_text_tower_layouts(layout):
    """The saved LLaVA-Llama-3 text tower loads from either layout
    (`model.layers.*` with `lm_head`, or bare `layers.*`): detect_prefix
    finds the tower, convert_hf_causal_lm takes every key under it and
    gives the same weights, which a CausalLM loads; a key left over under
    the prefix raises."""
    from diffusion_pipe_tpu_torch.models.llm_encoders import (CausalLM, CausalLMConfig,
                                                              convert_hf_causal_lm,
                                                              detect_prefix)

    full = _llama_checkpoint()
    sd = full if layout != "bare" else {k[len("model."):]: v for k, v in full.items()
                                        if k.startswith("model.")}
    prefix = detect_prefix(sd)
    assert prefix == ("model." if layout != "bare" else "")
    cfg = CausalLMConfig.from_hf_config(LLAMA, dtype=torch.float32)
    ours = convert_hf_causal_lm(sd, cfg, prefix=prefix)
    want = convert_hf_causal_lm(full, cfg, prefix="model.")
    assert set(ours) == set(want) and all(torch.equal(ours[k], want[k]) for k in want)
    assert torch.equal(ours["layers.2.attn_k.weight"],
                       full["model.layers.2.self_attn.k_proj.weight"])
    model = CausalLM(cfg)
    model.load_state_dict(ours)
    with pytest.raises(KeyError, match="does not take"):
        convert_hf_causal_lm({**sd, f"{prefix}layers.0.extra.weight": torch.zeros(1)}, cfg,
                             prefix=prefix)
