"""HunyuanImage-2.1 in the port vs the JAX package.

The `_tiny` config (2 + 2 blocks, 4 heads of 16, a 1-block refiner, 8
latent channels, Qwen 32 wide, byT5 16 through a mapper of 24, RoPE (8,
8), f32) with LoRA rank 4, LoRA B nonzero, on the HunyuanVideo blocks.
Seeded numpy weights on the JAX parameter structure cross through
interop.hunyuan_image_state_dict (byt5_layernorm / byt5_fc{i} as byt5_in's
layernorm / fc{i}; the JAX byt5_in GELU, tanh, through
interop.hunyuan_image_config). The batch: 6 x 10 latents (60 image
tokens), 5 Qwen rows (3 and 5 valid), 4 byT5 rows (2 and 0 valid), a loss
mask.

One jit holds the JAX side, from the JAX prepare_inputs' noise and t:
output, loss, LoRA gradients. Tolerances (f32): outputs rel L2 1e-4, loss
1e-5 relative, gradients 1e-4 abs / 1e-3 rel. The published byt5_in GELU
(exact) differs from the JAX one's output.

Exact: prepare_inputs; the byT5 quoted-span formatting against the JAX
pipeline's function; the KeyMap against the JAX keymap_from_flax, a
ComfyUI-dialect file loading bit for bit, raising on a missing key, on an
untaken one and naming a checkpoint's guidance_in and meanflow keys; the
LoRA export with the JAX export's (ComfyUI) keys and tensors and its
re-import; the layout from the keys; the published defaults.
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
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import hunyuan_image_config, hunyuan_image_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import hunyuan_image as thi
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models.hunyuan_image import HunyuanImageTransformer
from diffusion_pipe_tpu_torch.models.hunyuan_video import rename_keys
from diffusion_pipe_tpu_torch.models.layers import init_module_weights
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, jax_draws, random_params

KEY = jax.random.PRNGKey(21)
CFG = {"save_every_n_epochs": 1,
       "model": {"type": "hunyuan_image", "dtype": "float32", "_tiny": True},
       "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
       "optimizer": {"type": "adamw", "lr": 1e-3}}


def hi_batch(seed=43):
    rng = np.random.default_rng(seed)
    text_mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    byt5_mask = np.array([[1, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    return {"latents": (rng.standard_normal((2, 8, 6, 10)) * 0.5).astype(np.float32),
            "text_states": rng.standard_normal((2, 5, 32)).astype(np.float32),
            "text_mask": text_mask,
            "byt5_states": (rng.standard_normal((2, 4, 16)).astype(np.float32)
                            * byt5_mask[..., None]),
            "byt5_mask": byt5_mask,
            "mask": (rng.random((2, 12, 20)) > 0.4).astype(np.float32)}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@functools.lru_cache(maxsize=None)
def reference():
    jpipe = jax_model_class("hunyuan_image")(CFG)
    params = random_params(jpipe, seed=14, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    batch = hi_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(tr, fr, mi, target, lmask):
        out = jpipe.model.apply(merge_params(tr, fr), **mi)
        return jpipe.loss_fn(out, target, lmask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(tr, fr):
        mi, target, lmask = jpipe.prepare_inputs(KEY, jbatch)
        (l, out), grads = jax.value_and_grad(loss, has_aux=True)(tr, fr, mi, target, lmask)
        return dict(loss=l, out=out, grads=grads, x=mi["x"], t=mi["t"], target=target,
                    lmask=lmask)

    res = jax.tree.map(np.asarray, run(trainable, frozen))
    return dict(jpipe=jpipe, params=jax.tree.map(np.asarray, params), trainable=trainable,
                batch=batch, res=res)


def port_pipeline(ref, cfg=None):
    pipe = get_model_class("hunyuan_image")(CFG, device="cpu")
    want = cfg or hunyuan_image_config(ref["jpipe"].hi_config)
    assert pipe.hi_config == dataclasses.replace(want, byt5_gelu="tanh")
    pipe.hi_config = want
    pipe.model = HunyuanImageTransformer(want)
    pipe.model.load_state_dict(hunyuan_image_state_dict(ref["params"], want))
    return pipe


def _port_run(pipe, ref):
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    noise, t = jax_draws(ref["jpipe"], KEY, ref["batch"])
    inputs, target, mask = pipe.prepare_inputs(batch, noise=noise, t=t)
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(n))
    out = pipe.forward(inputs)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    return inputs, target, mask, out, loss


def test_prepare_inputs_matches():
    ref = reference()
    inputs, target, mask, _, _ = _port_run(port_pipeline(ref), ref)
    res = ref["res"]
    np.testing.assert_allclose(inputs["x"].numpy(), res["x"], atol=1e-6)
    np.testing.assert_allclose(target.numpy(), res["target"], atol=1e-6)
    np.testing.assert_allclose(inputs["t"].numpy(), res["t"], rtol=1e-6)
    np.testing.assert_array_equal(mask.expand(-1, 8, -1, -1).numpy(),
                                  np.broadcast_to(res["lmask"], target.shape))


def test_forward_and_lora_grads_match():
    """Output, loss and every LoRA gradient against the JAX module."""
    ref = reference()
    pipe = port_pipeline(ref)
    _, _, _, out, loss = _port_run(pipe, ref)
    res = ref["res"]
    assert rel_l2(out.detach().numpy(), res["out"]) < 1e-4
    np.testing.assert_allclose(loss.item(), float(res["loss"]), rtol=1e-5)
    want = hunyuan_image_state_dict(res["grads"], pipe.hi_config)
    factors = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    assert set(factors) == set(want) and len(want) == 2 * (2 * 10 + 2 * 3)
    for n, g in want.items():
        np.testing.assert_allclose(factors[n].grad.numpy(), g.numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=n)


def test_published_byt5_gelu_differs():
    """The published reading of byt5_in (exact GELU) moves the output; the
    rest of the model is the same."""
    ref = reference()
    cfg = dataclasses.replace(hunyuan_image_config(ref["jpipe"].hi_config), byt5_gelu="none")
    pipe = port_pipeline(ref, cfg)
    _, _, _, out, _ = _port_run(pipe, ref)
    d = rel_l2(out.detach().numpy(), ref["res"]["out"])
    assert 1e-6 < d < 1e-1, d


def test_byt5_formatting_matches_jax(monkeypatch):
    """byt5_prompts against the JAX pipeline's byT5 function: the strings
    handed to the byT5 encoder, and the zeroed rows of captions without a
    quoted span; the Qwen template, crop and length."""
    from diffusion_pipe_tpu.models import llm_encoders as jllm
    from diffusion_pipe_tpu.models import text_encoders as jte

    seen, made = [], []

    class Record:
        def __init__(self, *args, **kw):
            made.append((args, kw))

        def encode(self, caps, return_mask=False):
            seen.append(list(caps))
            return np.ones((len(caps), 3, 2), np.float32), np.ones((len(caps), 3), np.int32)

    monkeypatch.setattr(jllm, "LLMTextEncoder", Record)
    monkeypatch.setattr(jte, "HFTextEncoder", Record)
    mc = {"type": "hunyuan_image", "text_encoder_path": "qwen", "byt5_path": "byt5"}
    _, byt5_fn = jax_model_class("hunyuan_image")({"model": mc}).get_call_text_encoder_fns()
    caps = ['a sign that says "OPEN" and "24/7"', "no text here",
            "‘left’ and “right” quotes", 'mixed "a" ‘b’ “c”', ""]
    out = byt5_fn(caps)
    formatted, empty = thi.byt5_prompts(caps)
    assert seen == [formatted]
    assert formatted[0] == 'Text "OPEN". Text "24/7". '
    assert empty == [1, 4]
    zero = [i for i in range(len(caps)) if not out["byt5_states"][i].any()]
    assert zero == empty

    class PortRecord:
        def encode(self, caps, return_mask=False):
            seen.append(list(caps))
            return torch.ones((len(caps), 3, 2)), torch.ones((len(caps), 3), dtype=torch.int64)

    port = thi.byt5_text_fn(PortRecord())(caps)
    assert seen[-1] == formatted and port["byt5_mask"].dtype == torch.int32
    assert [i for i in range(len(caps)) if not port["byt5_states"][i].any()] == empty
    (_, qwen_kw), (byt5_args, byt5_kw) = made
    assert (qwen_kw["crop_start"], qwen_kw["max_length"], qwen_kw["hidden_layer"]) == (34, 966,
                                                                                     -3)
    assert byt5_args == ("t5", "byt5") and byt5_kw == {"max_length": 128}


def _jax_checkpoint(ref):
    jpipe = ref["jpipe"]
    frozen = partition_params(ref["params"], jax_lora)[1]
    return jkm.keymap_from_flax(frozen, jpipe.keymap(), jpipe.hi_config)


def test_keymap_load_export_reimport(tmp_path):
    """The KeyMap writes the JAX keymap_from_flax's names and tensors; a
    ComfyUI-dialect file (`_attn.qkv`, `_mlp.0`, `_mod.lin.`) loads bit for
    bit; without a key, with one the model does not take, or with
    guidance_in and meanflow keys it raises naming them; the LoRA goes out
    with the JAX export's ComfyUI keys and tensors and comes back."""
    ref = reference()
    pipe = port_pipeline(ref)
    jsd = _jax_checkpoint(ref)
    weights = {k: v for k, v in hunyuan_image_state_dict(ref["params"], pipe.hi_config).items()
               if "lora" not in k}
    out = tkm.keymap_from_state_dict(weights, pipe.keymap(), pipe.hi_config)
    assert set(out) == set(jsd)
    for k, v in jsd.items():
        assert torch.equal(out[k], torch.from_numpy(np.ascontiguousarray(v))), k
    comfy = rename_keys(out, [(new, old) for old, new in thi.COMFY_RENAMES])
    assert "double_blocks.0.img_mod.lin.weight" in comfy and "double_blocks.0.img_mlp.0.bias" \
        in comfy
    path = tmp_path / "hi.safetensors"
    safetensors_io.save_file({"model.diffusion_model." + k: v for k, v in comfy.items()},
                             str(path))

    def load(p):
        mc = dict(CFG["model"], transformer_path=str(p))
        return get_model_class("hunyuan_image")(dict(CFG, model=mc), device="cpu").load_weights()

    loaded = load(path)
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k])
                                               for k in loaded)
    dim = pipe.hi_config.hidden_size
    for name, bad, match in (
            ("missing", {k: v for k, v in out.items() if k != "byt5_in.fc2.weight"},
             "byt5_in.fc2.weight"),
            ("untaken", {**out, "single_blocks.1.extra.weight": torch.zeros(1)}, "extra"),
            ("guidance", {**out, "guidance_in.mlp.0.weight": torch.zeros(dim, 256),
                          "guidance_in.mlp.0.bias": torch.zeros(dim)}, "guidance_in"),
            ("meanflow", {**out, "time_r_in.mlp.0.weight": torch.zeros(dim, 256)},
             "time_r_in")):
        p = tmp_path / f"{name}.safetensors"
        safetensors_io.save_file(bad, str(p))
        with pytest.raises(KeyError, match=match):
            load(p)

    factors = {k: v.detach() for k, v in pipe.model.state_dict().items() if lora_predicate(k)}
    pipe.save_adapter(tmp_path / "adapter", factors)
    saved = safetensors_io.load_file(tmp_path / "adapter" / "adapter_model.safetensors")
    jpipe = ref["jpipe"]
    jax_export = {}
    jpipe.save_adapter(tmp_path / "jax_adapter", ref["trainable"])
    jax_export = safetensors_io.load_file(tmp_path / "jax_adapter" / "adapter_model.safetensors")
    assert set(saved) == set(jax_export)
    assert "diffusion_model.double_blocks.0.img_attn.qkv.lora_A.weight" in saved
    for k, v in jax_export.items():
        if not k.endswith(".alpha"):
            assert torch.equal(saved[k], v), k
    back = pipe.load_adapter(tmp_path / "adapter")
    assert set(back) == set(factors) and all(torch.equal(back[k], factors[k]) for k in back)


def test_layout_comes_from_the_checkpoint(tmp_path):
    """load_weights rebuilds the model on the keys' layout (2 + 1 blocks, 2
    refiner blocks, 3 heads of 16, 12 latent channels, text 20, byT5 10 /
    mapper 14) and loads it bit for bit; a [model] depth that disagrees
    raises."""
    pipe = get_model_class("hunyuan_image")(CFG, device="cpu")
    layout = dict(num_layers=2, num_single_layers=1, refiner_layers=2, num_attention_heads=3,
                  attention_head_dim=16, in_channels=12, out_channels=12, text_dim=20,
                  byt5_dim=10, byt5_mapper_dim=14)
    cfg = dataclasses.replace(pipe.hi_config, **layout)
    src = HunyuanImageTransformer(cfg)
    init_module_weights(src, torch.Generator().manual_seed(3))
    weights = {k: v for k, v in src.state_dict().items() if not lora_predicate(k)}
    path = tmp_path / "model.safetensors"
    safetensors_io.save_file(tkm.keymap_from_state_dict(weights, thi.hunyuan_image_keymap(cfg),
                                                        cfg), str(path))
    mc = dict(CFG["model"], transformer_path=str(path))
    pipe = get_model_class("hunyuan_image")(dict(CFG, model=mc), device="cpu")
    loaded = pipe.load_weights()
    assert all(getattr(pipe.hi_config, k) == v for k, v in layout.items())
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k]) for k in loaded)
    with pytest.raises(KeyError, match="num_layers"):
        get_model_class("hunyuan_image")(dict(CFG, model=dict(mc, num_layers=20)),
                                         device="cpu").load_weights()


def test_published_defaults():
    """HunyuanImage-2.1's layout: 20 + 40 blocks of 3,584 (28 heads of 128),
    64 latent channels at patch 1, RoPE (64, 64), Qwen 3,584, byT5 1,472
    through 2,048; the JAX defaults; 17.4 B parameters as the port builds
    them."""
    pipe = get_model_class("hunyuan_image")({"model": {"type": "hunyuan_image"}}, device="cpu")
    c = pipe.hi_config
    jcfg = jax_model_class("hunyuan_image")({"model": {"type": "hunyuan_image"}}).hi_config
    assert c == hunyuan_image_config(jcfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                     lora_dtype=c.lora_dtype)
    assert (c.num_layers, c.num_single_layers, c.hidden_size, c.in_channels, c.patch_size,
            c.rope_axes_dim, c.text_dim, c.byt5_dim) == (20, 40, 3584, 64, (1, 1), (64, 64),
                                                         3584, 1472)
    n = sum(p.numel() for p in pipe.model.parameters())
    assert round(n / 1e9, 1) == 17.4, n
