"""HiDream-I1 in the port vs the JAX package.

The `_tiny` config (2 + 2 blocks, 2 heads of 16, 4 routed experts of width
256 with top 2 and a shared one, T5 16 wide, Llama 24, pooled 16, f32) with
LoRA rank 4, LoRA B nonzero. Seeded numpy weights on the JAX parameter
structure (tests/torch_port_helpers.py) cross through
interop.hidream_state_dict. The batch: latents of 8 x 12 (24 image tokens),
8 T5 rows, 3 cached Llama layers of 6 rows, a loss mask.

One jit holds both references, from the JAX prepare_inputs' noise and t:
- the whole JAX module (interop.hidream_config: the carry of T5 alone, the
  layers cycled, RoPE (4, 6, 6)): output, loss, every adapter gradient,
  the gradients of the frozen expert banks and of the inputs (tokens,
  pooled, T5, Llama);
- the published form (the carry [T5, the last block's Llama state], the
  layers min(i, L - 1), RoPE (8, 4, 4)), composed of the JAX submodules as
  `hidream_published` below: output, loss, adapter and input gradients.
Tolerances (f32): outputs 1e-4, losses 1e-5 relative, gradients 1e-4 abs /
1e-3 rel (f32 sums in another order). The router's top 2 picks at least
three different expert pairs across the first block's tokens.

The port's adapters on the routed experts (the JAX experts have none): at
their initial zero delta the port is the JAX module, and each expert's
lora_b gradient is scaling (A - bound)^T times the JAX gradient of its
frozen weight; with nonzero deltas it matches the JAX module run on expert
weights with W + (alpha / r) (A - bound) B merged in (the same jit, other
arguments). One adamw step (clip 1.0, eps 1e-2) of the port's trainer:
its loss, its global norm and every factor against adamw's first step on
the clipped gradients above.

Exact: the KeyMap against the JAX keymap_from_flax both ways (per-expert
`ff_i.experts.{j}.w*`, `caption_projection.{n}.linear` with T5's last);
load_weights of a `diffusion_model.`-prefixed file, raising on a missing
and on an untaken key; the LoRA export (the JAX export's tensors plus the
experts' factors) and its re-import; a layout read from the keys, and a
[model] size that disagrees raising. The published defaults against the
JAX ones.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models import hidream as jhd
from diffusion_pipe_tpu.models import keymaps as jkm
from diffusion_pipe_tpu.models.layers import (LoraDense, layer_norm_no_affine, rope_frequencies,
                                              sinusoidal_timestep_embedding)
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import hidream_config, hidream_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models.hidream import (HiDreamConfig, HiDreamTransformer,
                                                     MoEFeedForward, hidream_keymap)
from diffusion_pipe_tpu_torch.models.layers import init_module_weights
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, jax_draws, random_params

KEY = jax.random.PRNGKey(16)
LR = 1e-3
CFG = {"save_every_n_epochs": 1,
       "model": {"type": "hidream", "dtype": "float32", "_tiny": True},
       "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
       "optimizer": {"type": "adamw", "lr": LR, "eps": 1e-2, "weight_decay": 0.01},
       "gradient_clipping": 1.0}
INPUTS = ("x_tokens", "pooled", "t5_embeds", "llama_embeds")
EXPERTS = ("experts_w1", "experts_w2", "experts_w3")
PUBLISHED_AXES = (8, 4, 4)


def hidream_batch(seed=31):
    rng = np.random.default_rng(seed)
    return {"latents": (rng.standard_normal((2, 16, 8, 12)) * 0.5).astype(np.float32),
            "t5_embeds": rng.standard_normal((2, 8, 16)).astype(np.float32),
            "pooled": rng.standard_normal((2, 16)).astype(np.float32),
            "llama_embeds": rng.standard_normal((2, 3, 6, 24)).astype(np.float32),
            "mask": (rng.random((2, 12, 20)) > 0.4).astype(np.float32)}


def hidream_published(cfg, params, x_tokens, img_ids, timesteps, pooled, t5_embeds,
                      llama_embeds, img_seq_len=None):
    """HiDream as the published model computes it, composed of the JAX
    package's submodules (its embedders, blocks and head applied with flax on
    their slices of the same parameters): the text carry [T5, the last
    block's Llama state], block i on Llama layer min(i, L - 1), RoPE axes
    PUBLISHED_AXES. The JAX module carries T5 alone and cycles the layers."""
    p = params["params"]
    dim = cfg.hidden_size
    dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)

    def dense(name, x, features=dim, bias=True):
        return LoraDense(features, use_bias=bias, **dd).apply({"params": p[name]}, x)

    img = dense("x_embedder", x_tokens)
    temb = dense("t_embed_2", jax.nn.silu(dense(
        "t_embed_1", sinusoidal_timestep_embedding(timesteps.astype(jnp.float32), 256))))
    temb = temb + dense("p_embed_2", jax.nn.silu(dense("p_embed_1", pooled)))
    nb = cfg.num_double_layers + cfg.num_single_layers
    n_layers = llama_embeds.shape[1]
    llama = [llama_embeds[:, min(i, n_layers - 1)] @ p["caption_projection"][i]
             for i in range(nb)]
    txt = jnp.concatenate([dense("t5_projection", t5_embeds, bias=False), llama[-1]], axis=1)
    rows = txt.shape[1] + llama[0].shape[1]
    ids = jnp.concatenate([img_ids, jnp.zeros((rows, 3), jnp.float32)], axis=0)
    cos, sin = rope_frequencies(ids, PUBLISHED_AXES, cfg.rope_theta)

    def block(stack, i):
        return jax.tree.map(lambda a: a[i], p[stack])

    for i in range(cfg.num_double_layers):
        (img, txt), _ = jhd.HiDreamDoubleBlock(cfg).apply(
            {"params": block("double_blocks", i)}, (img, txt), temb, llama[i], cos, sin)
    x = jnp.concatenate([img, txt], axis=1)
    for i in range(cfg.num_single_layers):
        x, _ = jhd.HiDreamSingleBlock(cfg).apply(
            {"params": block("single_blocks", i)}, x, temb,
            llama[cfg.num_double_layers + i], cos, sin)
    out = x[:, :img.shape[1]]
    if img_seq_len is not None:
        out = out[:, :img_seq_len]
    shift, scale = jnp.split(dense("final_mod", jax.nn.silu(temb), 2 * dim), 2, -1)
    out = layer_norm_no_affine(out) * (1 + scale[:, None]) + shift[:, None]
    return dense("proj_out", out, cfg.out_channels)


def _split_experts(frozen):
    """(the frozen tree without its expert banks, {path: bank})."""
    flat = traverse_util.flatten_dict(frozen)
    banks = {k: v for k, v in flat.items() if k[-1] in EXPERTS}
    rest = {k: v for k, v in flat.items() if k[-1] not in EXPERTS}
    return rest, banks


@functools.lru_cache(maxsize=None)
def reference():
    """The JAX pipeline, its weights, and `run` (jitted once): for
    (trainable, expert banks, the rest of the frozen tree) both references'
    outputs, losses and gradients (see the module docstring)."""
    jpipe = jax_model_class("hidream")(CFG)
    params = random_params(jpipe, seed=9, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    rest, banks = _split_experts(frozen)
    jbatch = {k: jnp.asarray(v) for k, v in hidream_batch().items()}

    def loss(form, tr, bk, inputs, rest_, mi, target, lmask):
        full = merge_params(tr, traverse_util.unflatten_dict({**rest_, **bk}))
        mi = dict(mi, **inputs)
        out = (jpipe.model.apply(full, **mi) if form == "jax"
               else hidream_published(jpipe.hd_config, full, **mi))
        return jpipe.loss_fn(out, target, lmask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(tr, bk, rest_):
        mi, target, lmask = jpipe.prepare_inputs(KEY, jbatch)
        inputs = {k: mi.pop(k) for k in INPUTS}
        args = (tr, bk, inputs, rest_, mi, target, lmask)
        jax_side = jax.value_and_grad(functools.partial(loss, "jax"), argnums=(0, 1, 2),
                                      has_aux=True)(*args)
        pub_side = jax.value_and_grad(functools.partial(loss, "published"), argnums=(0, 2),
                                      has_aux=True)(*args)
        return jax_side, pub_side

    return dict(jpipe=jpipe, params=jax.tree.map(np.asarray, params), trainable=trainable,
                rest=rest, banks=banks, run=run, batch=hidream_batch())


def _results(res):
    (loss, out), (g_tr, g_bk, g_in) = res[0]
    (p_loss, p_out), (p_tr, p_in) = res[1]
    conv = {k: np.asarray(v) for k, v in g_bk.items()}
    return dict(loss=float(loss), out=np.asarray(out),
                grads=hidream_state_dict(jax.tree.map(np.asarray, g_tr)), banks=conv,
                inputs={k: np.asarray(v) for k, v in g_in.items()},
                published=dict(loss=float(p_loss), out=np.asarray(p_out),
                               grads=hidream_state_dict(jax.tree.map(np.asarray, p_tr)),
                               inputs={k: np.asarray(v) for k, v in p_in.items()}))


@functools.lru_cache(maxsize=None)
def jax_results():
    ref = reference()
    return _results(ref["run"](ref["trainable"], ref["banks"], ref["rest"]))


def port_pipeline(ref, published=False, cfg=CFG):
    """The port's pipeline on the JAX weights, its expert adapters at their
    init (A uniform, B zero); published: the port's own `_tiny` form."""
    pipe = get_model_class("hidream")(cfg, device="cpu")
    jcfg = ref["jpipe"].hd_config
    want = hidream_config(jcfg)
    if published:
        assert pipe.hd_config == dataclasses.replace(
            want, published_carry=True, llama_layers="published", axes_dims_rope=PUBLISHED_AXES)
    else:
        pipe.hd_config = want
        pipe.model = HiDreamTransformer(want)
    pipe.model.to_empty(device="cpu")
    init_module_weights(pipe.model, torch.Generator().manual_seed(5))
    missing, unexpected = pipe.model.load_state_dict(hidream_state_dict(ref["params"]),
                                                     strict=False)
    assert not unexpected and missing and all(".experts." in k and "lora_" in k
                                              for k in missing)
    return pipe


def _port_run(pipe, ref, inputs_grad=True):
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    noise, t = jax_draws(ref["jpipe"], KEY, ref["batch"])
    inputs, target, mask = pipe.prepare_inputs(batch, noise=noise, t=t)
    for k in INPUTS:
        inputs[k] = inputs[k].detach().requires_grad_(inputs_grad)
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(n))
    out = pipe.forward(inputs)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    return out, loss, inputs


def _expert_lora_b_grads(pipe, banks):
    """scaling (A - bound)^T G for each expert linear: its lora_b gradient
    while B is zero, G the JAX gradient of the expert's frozen weight."""
    want = {}
    for (*_, stack, _, bank), g in banks.items():
        for i in range(g.shape[0]):
            for j in range(g.shape[1]):
                name = f"{stack}.{i}.ff_i.experts.{j}.{bank[len('experts_'):]}"
                lin = pipe.model.get_submodule(name)
                a = (lin.lora_a - lin.lora_bound).detach().numpy()
                want[name + ".lora_b"] = lin.lora_scaling * a.T @ g[i, j]
    return want


@pytest.mark.parametrize("form", ["jax", "published"])
def test_forward_and_grads_match(form):
    """The whole module against the JAX one (jax) or against the JAX
    submodules composed with the published carry, layers and axes
    (published): output, loss, every adapter gradient (the experts' lora_b
    against the JAX expert-weight gradients) and the input gradients."""
    ref = reference()
    want = jax_results() if form == "jax" else dict(jax_results()["published"])
    pipe = port_pipeline(ref, published=form == "published")
    picks = []
    gate = MoEFeedForward.gate_weights

    def record(self, x):
        w = gate(self, x)
        picks.append(w.detach())
        return w

    MoEFeedForward.gate_weights = record
    try:
        out, loss, inputs = _port_run(pipe, ref)
    finally:
        MoEFeedForward.gate_weights = gate
    pairs = {tuple(row.nonzero().flatten().tolist()) for row in picks[0].reshape(-1, 4)}
    assert len(pairs) >= 3 and all(len(p) == 2 for p in pairs), pairs
    np.testing.assert_allclose(out.detach().numpy(), want["out"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    for k in INPUTS:
        np.testing.assert_allclose(inputs[k].grad.numpy(), want["inputs"][k], atol=1e-4,
                                   rtol=1e-3, err_msg=k)
    factors = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    experts = {n for n in factors if ".experts." in n}
    assert set(factors) - experts == set(want["grads"])
    # a double block's 15 adapted linears and a single block's 8, plus 12
    # expert linears in each
    assert len(want["grads"]) == 2 * (2 * 15 + 2 * 8) and len(experts) == 2 * 4 * 12
    for n in want["grads"]:
        np.testing.assert_allclose(factors[n].grad.numpy(), want["grads"][n].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=n)
    if form == "jax":
        expert_b = _expert_lora_b_grads(pipe, want["banks"])
        assert set(expert_b) == {n for n in experts if n.endswith("lora_b")}
        for n, g in expert_b.items():
            np.testing.assert_allclose(factors[n].grad.numpy(), g, atol=1e-4, rtol=1e-3,
                                       err_msg=n)
            assert not factors[n.replace("lora_b", "lora_a")].grad.any()


def test_expert_adapters_merge_into_the_jax_experts():
    """Nonzero expert deltas: the port's output equals the JAX module's on
    expert weights W + (alpha / r) (A - bound) B."""
    ref = reference()
    pipe = port_pipeline(ref)
    gen = torch.Generator().manual_seed(7)
    banks = {k: np.array(v) for k, v in ref["banks"].items()}
    with torch.no_grad():
        for (*_, stack, _, bank), w in banks.items():
            for i in range(w.shape[0]):
                for j in range(w.shape[1]):
                    lin = pipe.model.get_submodule(
                        f"{stack}.{i}.ff_i.experts.{j}.{bank[len('experts_'):]}")
                    lin.lora_b.normal_(0.0, 0.05, generator=gen)
                    delta = lin.lora_scaling * (lin.lora_a - lin.lora_bound) @ lin.lora_b
                    w[i, j] += delta.numpy()
    merged = _results(ref["run"](ref["trainable"], {k: jnp.asarray(v) for k, v in banks.items()},
                                 ref["rest"]))
    out, _, _ = _port_run(pipe, ref, inputs_grad=False)
    np.testing.assert_allclose(out.detach().numpy(), merged["out"], atol=1e-4, rtol=1e-4)
    assert np.abs(merged["out"] - jax_results()["out"]).max() > 1e-3  # the deltas show


def _adamw_first_step(p0, g, lr, wd=0.01, eps=1e-2):
    """optax adamw's first update from zero moments: p - lr (g / (|g| + eps)
    + wd p), the decay on tensors of more than one dimension."""
    return p0 - lr * (g / (np.abs(g) + eps) + (wd * p0 if p0.ndim > 1 else 0))


def test_trainer_step_matches():
    """One step of the port's trainer (init_train_state over the JAX weights,
    adamw, clip 1.0) from the JAX noise and t: the loss, the global norm
    (the JAX adapter gradients with the experts' lora_b), every factor
    against adamw's first step on the clipped gradient; nothing else moves."""
    ref = reference()
    want = jax_results()
    pipe = port_pipeline(ref)
    expert_b = _expert_lora_b_grads(pipe, want["banks"])
    sd = pipe.model.state_dict()
    state = init_train_state(pipe, get_optimizer(CFG), torch.Generator().manual_seed(0),
                             lora_predicate, state_dict=sd)
    start = {n: p.detach().clone().numpy() for n, p in state.trainable.items()}
    frozen = {k: v.clone() for k, v in pipe.model.state_dict().items() if not lora_predicate(k)}
    noise, t = jax_draws(ref["jpipe"], KEY, ref["batch"])
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    m = make_train_step(pipe, gradient_clipping=1.0)(state, batch, noise=noise, t=t)
    grads = {n: (want["grads"][n].numpy() if n in want["grads"] else
                 expert_b.get(n, np.zeros_like(start[n]))) for n in state.trainable}
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    np.testing.assert_allclose(m["loss"].item(), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), norm, rtol=1e-4)
    clip = min(1.0, 1.0 / (norm + 1e-6))
    for name, p in state.trainable.items():
        g = grads[name] * clip
        want_p, got, zero = _adamw_first_step(start[name], g, LR), p.detach().numpy(), g == 0
        # gradients to 1e-4 move g / (|g| + eps) by up to 1e-2
        np.testing.assert_allclose(got[~zero], want_p[~zero], atol=2e-2 * LR, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(got[zero], want_p[zero], atol=0, rtol=1e-6, err_msg=name)
    after = pipe.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in frozen.items())


def _jax_checkpoint(ref):
    jpipe = ref["jpipe"]
    frozen = partition_params(ref["params"], jax_lora)[1]
    return jkm.keymap_from_flax(frozen, jpipe.keymap(), jpipe.hd_config)


def test_keymap_matches_jax_both_ways():
    """The port's KeyMap writes the JAX keymap_from_flax's names and tensors
    (per-expert banks, the router, the shared expert, the caption
    projections with T5's last) and reads them back."""
    ref = reference()
    sd = _jax_checkpoint(ref)
    pipe = get_model_class("hidream")(CFG, device="cpu")
    weights = {k: v for k, v in hidream_state_dict(ref["params"]).items() if "lora" not in k}
    out = tkm.keymap_from_state_dict(weights, pipe.keymap(), pipe.hd_config)
    assert set(out) == set(sd)
    for k, v in sd.items():
        assert torch.equal(out[k], torch.from_numpy(np.ascontiguousarray(v))), k
    back = tkm.keymap_to_state_dict(out, pipe.keymap(), pipe.hd_config)
    assert set(back) == set(weights) and all(torch.equal(back[k], weights[k]) for k in back)
    assert sd["double_stream_blocks.1.block.ff_i.experts.3.w2.weight"].shape == (32, 256)
    assert sd["caption_projection.4.linear.weight"].shape == (32, 16)  # T5's, last
    assert "single_stream_blocks.0.block.ff_i.gate.weight" in sd


def test_load_export_reimport(tmp_path):
    """A `diffusion_model.`-prefixed file loads bit for bit; without a key,
    or with one the model does not take, it raises. The adapter goes out
    with the JAX export's tensors and the experts' factors besides, and
    comes back bit for bit."""
    ref = reference()
    sd = {"diffusion_model." + k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in _jax_checkpoint(ref).items()}
    path = tmp_path / "hidream.safetensors"
    safetensors_io.save_file(sd, str(path))
    pipe = get_model_class("hidream")(dict(CFG, model=dict(CFG["model"],
                                                           transformer_path=str(path))),
                                      device="cpu")
    loaded = pipe.load_weights()
    weights = hidream_state_dict(ref["params"])
    assert set(loaded) == {k for k in weights if "lora" not in k}
    assert all(torch.equal(loaded[k], weights[k]) for k in loaded)
    for name, bad in (("missing", {k: v for k, v in sd.items() if ".gate." not in k}),
                      ("untaken", {**sd, "diffusion_model.double_stream_blocks.0.block.x.weight":
                                   torch.zeros(1)})):
        safetensors_io.save_file(bad, str(tmp_path / f"{name}.safetensors"))
        broken = get_model_class("hidream")(
            dict(CFG, model=dict(CFG["model"], transformer_path=str(tmp_path /
                                                                   f"{name}.safetensors"))),
            device="cpu")
        with pytest.raises(KeyError, match="gate" if name == "missing" else "block.x"):
            broken.load_weights()

    port = port_pipeline(ref)
    factors = {k: v.detach() for k, v in port.model.state_dict().items() if lora_predicate(k)}
    with torch.no_grad():
        for k, v in factors.items():
            if ".experts." in k and k.endswith("lora_b"):
                v.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    port.save_adapter(tmp_path / "adapter", factors)
    saved = safetensors_io.load_file(tmp_path / "adapter" / "adapter_model.safetensors")
    jpipe = ref["jpipe"]
    jax_export = jkm.export_lora_keymap(ref["trainable"], jpipe.keymap(), jpipe.hd_config)
    for k, v in jax_export.items():
        assert torch.equal(saved[k], torch.from_numpy(np.ascontiguousarray(v))), k
    extra = {k for k in saved if k.endswith(".lora_A.weight")} - set(jax_export)
    assert extra == {f"diffusion_model.{g}.{i}.block.ff_i.experts.{j}.{w}.lora_A.weight"
                     for g in ("double_stream_blocks", "single_stream_blocks")
                     for i in range(2) for j in range(4) for w in ("w1", "w2", "w3")}
    assert sum(k.endswith(".alpha") for k in saved) == 2 * (15 + 8) + 2 * 2 * 12
    back = port.load_adapter(tmp_path / "adapter")
    assert set(back) == set(factors) and all(torch.equal(back[k], factors[k]) for k in back)


# a layout unlike the tiny one in every field the keys give: 1 + 3 blocks,
# 48 wide (3 heads of 16), 3 experts of 64 and a shared one of 40, T5 12,
# Llama 20, pooled 10
LAYOUT = dict(num_double_layers=1, num_single_layers=3, hidden_size=48, num_heads=3,
              num_routed_experts=3, expert_hidden=64, shared_hidden=40, t5_dim=12,
              llama_dim=20, pooled_dim=10)


def test_layout_comes_from_the_checkpoint(tmp_path):
    """load_weights rebuilds the model on the layout of the checkpoint's keys
    and loads it bit for bit; a [model] size that disagrees with the keys
    raises, naming it."""
    pipe = get_model_class("hidream")(CFG, device="cpu")
    cfg = dataclasses.replace(pipe.hd_config, **LAYOUT)
    src = HiDreamTransformer(cfg)
    init_module_weights(src, torch.Generator().manual_seed(3))
    weights = {k: v for k, v in src.state_dict().items() if not lora_predicate(k)}
    path = tmp_path / "model.safetensors"
    safetensors_io.save_file(tkm.keymap_from_state_dict(weights, hidream_keymap(cfg), cfg),
                             str(path))
    pipe = get_model_class("hidream")(dict(CFG, model=dict(CFG["model"],
                                                           transformer_path=str(path))),
                                      device="cpu")
    loaded = pipe.load_weights()
    assert all(getattr(pipe.hd_config, k) == v for k, v in LAYOUT.items())
    assert set(loaded) == set(weights) and all(torch.equal(loaded[k], weights[k]) for k in loaded)
    pipe.model.to_empty(device="cpu")
    pipe.model.load_state_dict(loaded, strict=False)
    with pytest.raises(KeyError, match="num_routed_experts"):
        get_model_class("hidream")(dict(CFG, model=dict(
            CFG["model"], transformer_path=str(path), num_routed_experts=4)),
            device="cpu").load_weights()


def test_published_defaults():
    """HiDream-I1's published layout: 16 + 32 blocks, 2,560 wide, 20 heads of
    128, experts and ff_t 6,912 wide, the shared expert 3,584, T5 and Llama
    4,096, pooled 2,048, 4 experts top 2; the carry [T5, the last Llama
    state], layers 0..31 then 31, RoPE (64, 32, 32): 17.1 B parameters as
    the port builds it. The JAX defaults: the same sizes, the T5 carry,
    the layers cycled, (32, 48, 48); axes that do not sum to the head dim
    raise."""
    pipe = get_model_class("hidream")({"model": {"type": "hidream"}}, device="cpu")
    c = pipe.hd_config
    jcfg = jax_model_class("hidream")({"model": {"type": "hidream"}}).hd_config
    assert (c.num_double_layers, c.num_single_layers, c.hidden_size, c.num_heads,
            c.head_dim) == (16, 32, 2560, 20, 128)
    assert (c.ff_hidden, c.shared_ff_hidden) == (6912, 3584) == (
        jhd.swiglu_hidden(2560, 4.0), jhd.swiglu_hidden(2560, 2.0))
    assert (c.t5_dim, c.llama_dim, c.pooled_dim, c.num_routed_experts,
            c.num_activated_experts) == (4096, 4096, 2048, 4, 2)
    assert c.published_carry and c.axes_dims_rope == (64, 32, 32)
    assert c.block_layers(32) == tuple(range(32)) + (31,) * 16
    assert c == dataclasses.replace(
        hidream_config(jcfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                       lora_dtype=c.lora_dtype),
        published_carry=True, llama_layers="published", axes_dims_rope=(64, 32, 32))
    assert jcfg.axes_dims_rope == (32, 48, 48) and jcfg.llama_layers is None
    assert hidream_config(jcfg).block_layers(32) == tuple(i % 32 for i in range(48))
    n = sum(p.numel() for p in pipe.model.parameters())
    assert round(n / 1e9, 1) == 17.1, n
    with pytest.raises(ValueError, match="head dim 16"):
        HiDreamTransformer(HiDreamConfig.tiny(axes_dims_rope=(4, 4, 4)))
    over = get_model_class("hidream")({"model": {"type": "hidream", "_tiny": True,
                                                 "llama_layers": [1, 0, 1, 0]}}, device="cpu")
    assert over.hd_config.block_layers(2) == (1, 0, 1, 0)
