"""Shared inputs for the tiny-Flux and tiny-Wan parity tests of the PyTorch port.

Weights are made with numpy from a seed on the JAX package's parameter
structure (jax.eval_shape of its init, no compile): kernels lecun-scaled
normals (cast to fp8 where the structure stores them so), biases,
modulation tables and norm scales perturbed away from 0
and 1 so the mapping of each leaf is tested, LoRA A stored uniform in
[0, 2*sqrt(6/in)) as the JAX package stores it, LoRA B zero or a small
normal.
"""

import functools
import json
import os
import re

# transformers imports TensorFlow when it finds it (seconds a process), and
# no port test uses it
os.environ.setdefault("USE_TF", "0")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

from diffusion_pipe_tpu.models.layers import prequantize_int8_tree  # noqa: E402
from diffusion_pipe_tpu.training.flow import sample_timesteps  # noqa: E402
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a port test module runs (six xdist workers
    share the host), restored afterwards for the other modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The bf16 spacing at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def tiny_flux_config(**top):
    cfg = {
        "save_every_n_epochs": 1,
        "model": {"type": "flux", "dtype": "float32", "_tiny": True},
        "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
        "optimizer": {"type": "adamw8bit", "lr": 2e-3},
    }
    cfg.update(top)
    return cfg


_SHAPES = {}


def param_shapes(pipeline):
    """jax.eval_shape of the JAX pipeline's init_params, traced once a
    process for each model (its module's repr, which holds its config) and
    model / adapter config: the test files share it."""
    # the checkpointing policy wraps blocks without renaming a parameter
    model = re.sub(r"remat=[^,)]*", "", repr(getattr(pipeline, "model", None)))
    key = (type(pipeline).__name__, model,
           json.dumps({k: pipeline.config.get(k) for k in ("model", "adapter")},
                      sort_keys=True, default=str))
    if key not in _SHAPES:
        _SHAPES[key] = nn.unbox(jax.eval_shape(pipeline.init_params, jax.random.PRNGKey(0)))
    return _SHAPES[key]


def random_params(pipeline, seed, lora_b_std=0.0):
    """A numpy parameter tree with the JAX pipeline's structure."""
    rng = np.random.default_rng(seed)
    shapes = param_shapes(pipeline)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":  # fp8 storage keeps its dtype (transformer_dtype)
            k = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
            return k.astype(leaf.dtype) if leaf.dtype.itemsize == 1 else k
        if name == "lora_a":
            bound = np.sqrt(6.0 / shape[-2])
            return rng.uniform(0.0, 2 * bound, shape).astype(np.float32)
        if name == "lora_b":
            return (rng.standard_normal(shape) * lora_b_std).astype(np.float32)
        if name.endswith("scale"):  # RMSNorm scale, Wan's norm3_scale
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)  # bias, modulation

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {
        "latents": (rng.standard_normal((b, 16, 8, 8)) * 0.5).astype(np.float32),
        "t5_embed": rng.standard_normal((b, 8, 64)).astype(np.float32),
        "clip_embed": rng.standard_normal((b, 32)).astype(np.float32),
    }


# XLA CPU compile options for the JAX references: LLVM at optimisation level
# 0 and the older fusion emitters compile a tiny model's train step about
# five times faster than the defaults; one LLVM module instead of parallel
# parts takes a fifth off that on one core (the code is the same).
JAX_FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False,
                    "xla_cpu_parallel_codegen_split_count": 1}


def draw_noise_and_t(tdist, key, shape):
    """The noise and t that the JAX prepare_inputs draws from `key` for
    latents of `shape`, as JAX arrays (traceable inside a jit)."""
    t_key, n_key = jax.random.split(key)
    b, h, w = shape[0], shape[-2], shape[-1]  # [B, C, H, W] or [B, C, F, H, W]
    t = sample_timesteps(t_key, b, tdist, image_seq_len=(h // 2) * (w // 2))
    return jax.random.normal(n_key, shape, jnp.float32), t


_draws = jax.jit(draw_noise_and_t, static_argnums=(0, 2), compiler_options=JAX_FAST_COMPILE)


def jax_draws(pipeline, key, batch):
    """The noise and t that the JAX prepare_inputs draws from `key`."""
    noise, t = _draws(pipeline.tdist, key, tuple(batch["latents"].shape))
    return torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(t))


_prequantize = jax.jit(prequantize_int8_tree, compiler_options=JAX_FAST_COMPILE)


def jax_initial_state(params, predicate):
    """The trainable and frozen trees that the JAX init_train_state builds
    from `params` (its frozen block kernels pre-quantized to int8 where the
    config asks), and the whole tree as a port state_dict, for tests that
    take no JAX optimizer step: init_train_state's eager optimizer init and
    its prequantize_int8_tree compiled with the default options take
    seconds, and give the same trees bit for bit."""
    from diffusion_pipe_tpu_torch.interop import jax_to_state_dict

    from flax import traverse_util

    trainable, frozen = partition_params(params, predicate)
    if any(k[-1] == "kernel_scale" and v is not None
           for k, v in traverse_util.flatten_dict(frozen).items()):
        frozen = _prequantize(frozen)
    sd = jax_to_state_dict(jax.tree.map(np.asarray, merge_params(trainable, frozen)))
    return trainable, frozen, sd


# --- one-SiLU oracles ---------------------------------------------------------
# The JAX FluxTransformer and SD3Transformer apply SiLU to the timestep
# embedding before their blocks, which apply it again (diffusers, BFL and
# ComfyUI apply it once). The port applies it once, so its reference is the
# JAX package's own submodules composed that way: each applied with flax on
# its slice of the same parameters, the raw embedding into the blocks and
# silu(temb) into the output norm.


def flux_one_silu(model, params, hidden_states, encoder_hidden_states, pooled_projections,
                  timestep, img_ids, txt_ids, guidance=None, txt_mask=None, img_seq_len=None):
    """The JAX FluxTransformer `model`'s function with SiLU applied once."""
    from diffusion_pipe_tpu.models.layers import (layer_norm_no_affine, modulate,
                                                  rope_frequencies)

    cfg = model.config

    def sub(name, *args):
        return model.apply(params, *args, method=lambda m, *a: getattr(m, name)(*a))

    img = sub("x_embedder", hidden_states)
    txt = sub("context_embedder", encoder_hidden_states)
    temb = model.apply(params, timestep, guidance, pooled_projections,
                       method=type(model).time_text_embed)
    rope_cos, rope_sin = rope_frequencies(jnp.concatenate([txt_ids, img_ids], axis=0),
                                          cfg.axes_dims_rope, cfg.rope_theta)
    rope_cos, rope_sin = rope_cos.astype(jnp.float32), rope_sin.astype(jnp.float32)
    assert cfg.double_split[1] == 0 and cfg.single_split[1] == 0, "no swap split here"
    (img, txt), _ = sub("double_blocks", (img, txt), temb, rope_cos, rope_sin, txt_mask)
    x = jnp.concatenate([txt, img], axis=1)
    kv_mask = None
    if txt_mask is not None:
        kv_mask = jnp.concatenate([txt_mask.astype(jnp.int32),
                                   jnp.ones(img.shape[:2], jnp.int32)], axis=1)
    x, _ = sub("single_blocks", x, temb, rope_cos, rope_sin, kv_mask)
    out = x[:, txt.shape[1]:]
    if img_seq_len is not None:
        out = out[:, :img_seq_len]
    scale, shift = jnp.split(sub("norm_out_linear", jax.nn.silu(temb)), 2, axis=-1)
    return sub("proj_out", modulate(layer_norm_no_affine(out), shift, scale))


def sd3_one_silu(model, params, hidden_states, timestep, encoder_hidden_states,
                 pooled_projections):
    """The JAX SD3Transformer `model`'s function with SiLU applied once."""
    from diffusion_pipe_tpu.models.layers import (LoraDense, PixArtAlphaTextProjection,
                                                  TimestepEmbedder, layer_norm_no_affine,
                                                  modulate)
    from diffusion_pipe_tpu.models.sd3_model import SD3JointBlock, sincos_2d_pos_embed

    cfg = model.config
    p = params["params"]
    dim, ps = cfg.hidden_size, cfg.patch_size
    dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
    b, c, h, w = hidden_states.shape
    gh, gw = h // ps, w // ps
    x = jnp.transpose(hidden_states, (0, 2, 3, 1)).astype(cfg.dtype)
    x = x.reshape(b, gh, ps, gw, ps, c).transpose(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, -1)
    img = LoraDense(dim, **dd).apply({"params": p["pos_embed_proj"]}, x)
    m = cfg.pos_embed_max_size
    table = sincos_2d_pos_embed(dim, m, cfg.sample_size // ps).reshape(m, m, dim)
    top, left = (m - gh) // 2, (m - gw) // 2
    img = img + jnp.asarray(table[top:top + gh, left:left + gw].reshape(1, gh * gw, dim)
                            ).astype(img.dtype)
    temb = TimestepEmbedder(dim, **dd).apply({"params": p["timestep_embedder"]},
                                             timestep.astype(jnp.float32))
    temb = temb + PixArtAlphaTextProjection(dim, **dd).apply(
        {"params": p["text_embedder"]}, pooled_projections.astype(cfg.dtype))
    txt = LoraDense(dim, **dd).apply({"params": p["context_embedder"]},
                                     encoder_hidden_states.astype(cfg.dtype))
    blocks = nn.scan(SD3JointBlock, variable_axes={"params": 0}, split_rngs={"params": True},
                     in_axes=nn.broadcast, length=cfg.num_layers - 1)(cfg)
    (img, txt), _ = blocks.apply({"params": p["blocks"]}, (img, txt), temb)
    (img, _), _ = SD3JointBlock(cfg, context_pre_only=True).apply(
        {"params": p["final_block"]}, (img, txt), temb)
    mod = LoraDense(2 * dim, **dd).apply({"params": p["norm_out_linear"]}, jax.nn.silu(temb))
    scale, shift = jnp.split(mod, 2, axis=-1)
    img = modulate(layer_norm_no_affine(img), shift, scale)
    out = LoraDense(ps * ps * cfg.out_channels, **dd).apply({"params": p["proj_out"]}, img)
    out = out.reshape(b, gh, gw, ps, ps, cfg.out_channels).transpose(0, 5, 1, 3, 2, 4)
    return out.reshape(b, cfg.out_channels, h, w)


def one_silu(jpipe):
    """The JAX Flux or SD3 pipeline `jpipe` with its forward (which the JAX
    trainer, loss and sampler call) replaced by the one-SiLU composition."""
    fn = {"FluxTransformer": flux_one_silu, "SD3Transformer": sd3_one_silu}[
        type(jpipe.model).__name__]
    jpipe.forward = lambda params, model_inputs: fn(jpipe.model, params, **model_inputs)
    return jpipe


QWEN_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|vision_start|>",
                 "<|vision_end|>", "<|image_pad|>")


def write_qwen_tokenizer(folder, words):
    """A synthetic Qwen2-style tokenizer in `folder`: word-level over
    whitespace-split `words` (unknown words to <unk>), the chat template's
    special tokens after them, <|endoftext|> the padding. Returns the
    token -> id map."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(["<unk>"] + list(words))}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                   pad_token="<|endoftext|>",
                                   additional_special_tokens=list(QWEN_SPECIALS[1:]))
    fast.save_pretrained(str(folder))
    return fast.get_vocab()


def qwen_one_silu(model, params, hidden_states, encoder_hidden_states, timestep, img_ids,
                  txt_ids, txt_mask=None, img_seq_len=None):
    """The JAX QwenImageTransformer `model`'s submodules composed with SiLU
    applied once to temb and the RoPE tables of the given (port) ids: the
    JAX module builds Flux's uncentred ids itself."""
    from diffusion_pipe_tpu.models.flux_model import FluxDoubleBlock
    from diffusion_pipe_tpu.models.layers import (LoraDense, RMSNorm, TimestepEmbedder,
                                                  layer_norm_no_affine, modulate,
                                                  rope_frequencies)

    cfg = model.config
    p = params["params"]
    dim = cfg.hidden_size
    dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
    img = LoraDense(dim, **dd).apply({"params": p["img_in"]}, hidden_states.astype(cfg.dtype))
    txt = RMSNorm(dtype=cfg.dtype, param_dtype=cfg.param_dtype).apply(
        {"params": p["txt_norm"]}, encoder_hidden_states.astype(cfg.dtype))
    txt = LoraDense(dim, **dd).apply({"params": p["txt_in"]}, txt)
    temb = TimestepEmbedder(dim, **dd).apply({"params": p["time_text_embed"]},
                                             timestep.astype(jnp.float32) * 1000.0)
    rope_cos, rope_sin = rope_frequencies(jnp.concatenate([txt_ids, img_ids], axis=0),
                                          tuple(cfg.axes_dims_rope), cfg.rope_theta)
    blocks = nn.scan(FluxDoubleBlock, variable_axes={"params": 0}, split_rngs={"params": True},
                     in_axes=nn.broadcast, length=cfg.num_layers)(cfg.to_flux_config())
    (img, _), _ = blocks.apply({"params": p["blocks"]}, (img, txt), temb, rope_cos, rope_sin,
                               txt_mask)
    out = img if img_seq_len is None else img[:, :img_seq_len]
    mod = LoraDense(2 * dim, **dd).apply({"params": p["norm_out_linear"]}, jax.nn.silu(temb))
    scale, shift = jnp.split(mod, 2, axis=-1)
    return LoraDense(cfg.out_channels, **dd).apply(
        {"params": p["proj_out"]}, modulate(layer_norm_no_affine(out), shift, scale))


# --- FLUX.2 in its published layout -----------------------------------------


def flux2_published(cfg, p, hidden_states, encoder_hidden_states, timestep, img_ids,
                    guidance=None, img_seq_len=None):
    """FLUX.2 as the published model computes it, composed of the JAX
    package's submodules (LoraDense, RMSNorm, rope_frequencies / apply_rope,
    dot_product_attention, layer_norm_no_affine, modulate,
    sinusoidal_timestep_embedding), for the layout of `cfg` (a port
    Flux2Config: SwiGLU or GELU MLP, biases, txt_norm, RoPE axes, theta and
    text axes). `p` maps each port module path to its leaves in the JAX
    layout ({"kernel" [in, out], "bias", "lora_a", "lora_b"} or {"scale"}).
    The JAX Flux2Transformer computes the JAX layout only."""
    from diffusion_pipe_tpu.models.layers import (LoraDense, RMSNorm, apply_rope,
                                                  layer_norm_no_affine, modulate,
                                                  rope_frequencies,
                                                  sinusoidal_timestep_embedding)
    from diffusion_pipe_tpu.ops.attention import dot_product_attention

    dim, hd = cfg.hidden_size, cfg.attention_head_dim
    dt = jnp.float32
    lora = dict(lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)

    def dense(name, x, dtype=dt):
        leaves = p[name]
        m = LoraDense(leaves["kernel"].shape[1], use_bias="bias" in leaves, dtype=dtype,
                      param_dtype=dt, **(lora if "lora_a" in leaves else {}))
        return m.apply({"params": leaves}, x)

    def norm(name, x):
        return RMSNorm(dtype=dt, param_dtype=dt).apply({"params": p[name]}, x)

    def act(y):
        if cfg.mlp_gated:
            a, b = jnp.split(y, 2, -1)
            return jax.nn.silu(a) * b
        return jax.nn.gelu(y, approximate=True)

    def heads(x):
        return x.reshape(x.shape[0], x.shape[1], -1, hd)

    img = dense("img_in", hidden_states)
    txt = encoder_hidden_states
    if cfg.txt_norm:
        txt = norm("txt_norm", txt)
    txt = dense("txt_in", txt)
    vec = dense("time_in_2", jax.nn.silu(dense("time_in_1", sinusoidal_timestep_embedding(
        timestep * 1000.0, 256))))
    if cfg.guidance_embeds and guidance is not None:
        vec = vec + dense("guidance_in_2", jax.nn.silu(dense(
            "guidance_in_1", sinusoidal_timestep_embedding(guidance * 1000.0, 256))))
    sv = jax.nn.silu(vec)
    mi = jnp.split(dense("double_stream_modulation_img", sv), 6, -1)
    mt = jnp.split(dense("double_stream_modulation_txt", sv), 6, -1)
    ms = jnp.split(dense("single_stream_modulation", sv), 3, -1)
    st = txt.shape[1]
    txt_ids = np.zeros((st, len(cfg.axes_dims_rope)), np.float32)
    for ax in cfg.txt_ids_dims:
        txt_ids[:, ax] = np.arange(st)
    cos, sin = rope_frequencies(jnp.concatenate([jnp.asarray(txt_ids), img_ids], 0),
                                tuple(cfg.axes_dims_rope), cfg.rope_theta)

    for i in range(cfg.num_layers):
        b = f"double_blocks.{i}."
        qkv = {}
        for s, x, m in (("img", img, mi), ("txt", txt, mt)):
            q, k, v = (heads(u) for u in jnp.split(
                dense(b + f"{s}_attn_qkv", modulate(layer_norm_no_affine(x), m[0], m[1])), 3, -1))
            qkv[s] = (norm(b + f"{s}_attn_q_norm", q), norm(b + f"{s}_attn_k_norm", k), v)
        q, k, v = (jnp.concatenate([qkv["txt"][j], qkv["img"][j]], 1) for j in range(3))
        attn = dot_product_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
        attn = attn.reshape(attn.shape[0], attn.shape[1], dim)
        out = {}
        for s, x, m, a in (("img", img, mi, attn[:, st:]), ("txt", txt, mt, attn[:, :st])):
            x = x + m[2][:, None] * dense(b + f"{s}_attn_proj", a)
            y = modulate(layer_norm_no_affine(x), m[3], m[4])
            y = dense(b + f"{s}_mlp_fc2", act(dense(b + f"{s}_mlp_fc1", y)))
            out[s] = x + m[5][:, None] * y
        img, txt = out["img"], out["txt"]

    x = jnp.concatenate([txt, img], 1)
    for i in range(cfg.num_single_layers):
        b = f"single_blocks.{i}."
        y = dense(b + "linear1", modulate(layer_norm_no_affine(x), ms[0], ms[1]))
        q, k, v = (heads(u) for u in jnp.split(y[..., :3 * dim], 3, -1))
        q = apply_rope(norm(b + "q_norm", q), cos, sin)
        k = apply_rope(norm(b + "k_norm", k), cos, sin)
        attn = dot_product_attention(q, k, v)
        attn = attn.reshape(attn.shape[0], attn.shape[1], dim)
        x = x + ms[2][:, None] * dense(b + "linear2",
                                       jnp.concatenate([attn, act(y[..., 3 * dim:])], -1))
    out = x[:, st:]
    if img_seq_len is not None:
        out = out[:, :img_seq_len]
    shift, scale = jnp.split(dense("final_mod", sv), 2, -1)
    return dense("final_linear", modulate(layer_norm_no_affine(out), shift, scale))


def port_to_jax_leaves(state_dict):
    """A port state dict (torch tensors) as {module path: {leaf: numpy}} in
    the JAX layouts: a `weight` [out, in] as `kernel` [in, out]."""
    out = {}
    for key, t in state_dict.items():
        path, leaf = key.rsplit(".", 1)
        arr = t.detach().float().numpy()
        if leaf == "weight":
            leaf, arr = "kernel", np.ascontiguousarray(arr.T)
        out.setdefault(path, {})[leaf] = arr
    return out


# --- AuraFlow's diffusers layout ---------------------------------------------

AURAFLOW_JOINT_MAP = {
    "norm1_linear": "norm1.linear", "norm1_context_linear": "norm1_context.linear",
    "attn_to_q": "attn.to_q", "attn_to_k": "attn.to_k", "attn_to_v": "attn.to_v",
    "attn_add_q": "attn.add_q_proj", "attn_add_k": "attn.add_k_proj",
    "attn_add_v": "attn.add_v_proj", "attn_to_out": "attn.to_out.0",
    "attn_to_add_out": "attn.to_add_out", "ff_linear_1": "ff.linear_1",
    "ff_linear_2": "ff.linear_2", "ff_out_projection": "ff.out_projection",
    "ff_context_linear_1": "ff_context.linear_1", "ff_context_linear_2": "ff_context.linear_2",
    "ff_context_out_projection": "ff_context.out_projection",
}


def auraflow_fake_sd(params, cfg):
    """The JAX test suite's inverse of convert_diffusers_auraflow
    (tests/test_auraflow.py `_fake_sd_from_params`, copied since a test
    file is not imported as a module): JAX AuraFlow params -> the
    diffusers-keyed state dict (numpy) that the converter reads."""
    p = params["params"]
    sd = {"pos_embed.pos_embed": np.asarray(p["pos_embed"]),
          "register_tokens": np.asarray(p["register_tokens"])}

    def put(theirs, leaf, bias=True):
        sd[theirs + ".weight"] = np.asarray(leaf["kernel"]).T
        if bias and "bias" in leaf:
            sd[theirs + ".bias"] = np.asarray(leaf["bias"])

    put("pos_embed.proj", p["patch_proj"])
    put("context_embedder", p["context_embedder"], bias=False)
    put("time_step_proj.linear_1", p["time_linear_1"])
    put("time_step_proj.linear_2", p["time_linear_2"])
    put("norm_out.linear", p["norm_out_linear"], bias=False)
    put("proj_out", p["proj_out_linear"], bias=False)
    single_map = {k: v for k, v in AURAFLOW_JOINT_MAP.items()
                  if "context" not in k and "add" not in k}
    for ours, theirs in AURAFLOW_JOINT_MAP.items():
        stacked = np.asarray(p["joint_blocks"][ours]["kernel"])
        for i in range(cfg.num_layers):
            sd[f"joint_transformer_blocks.{i}.{theirs}.weight"] = stacked[i].T
    for ours, theirs in single_map.items():
        stacked = np.asarray(p["single_blocks"][ours]["kernel"])
        for i in range(cfg.num_single_layers):
            sd[f"single_transformer_blocks.{i}.{theirs}.weight"] = stacked[i].T
    return sd
