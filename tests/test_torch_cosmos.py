"""Cosmos-Predict2, Anima and Cosmos-1 in the port vs the JAX package.

The `_tiny` MiniTrainDIT (2 blocks, 64 wide, 4 heads of 16, context 32,
adaLN-LoRA 16, f32) with LoRA rank 4, LoRA B nonzero; Anima's tiny
LLMAdapter (Qwen 16 wide -> T5 32 through a 32-wide model, 2 layers).
Seeded numpy weights on the JAX parameter structures
(tests/torch_port_helpers.py) cross through
interop.cosmos_predict2_state_dict and llm_adapter_state_dict. One jit holds every JAX reference:
- the DiT module on an image and a 2-latent-frame video with a nonzero
  padding mask: output, loss, the gradients of every parameter and of the
  inputs;
- Anima's pipeline from its prepare_inputs (t, noise, target, mask) through
  the adapter, the zeroed padded rows and the DiT: output, loss (with
  multiscale_loss_weight set), every gradient; the multiscale term on a
  120 x 120 latent (960 px, one pooled term);
- Cosmos-1's EDM pipeline (sigma, noise, the net input, c_noise, x0, the
  weighted loss, every gradient), the EDM functions, the Karras sampler at 3
  steps;
- the LLMAdapter alone with and without self-attention, with and without
  in_proj, under partial masks and an all-zero llm_mask.
Tolerances (f32): outputs 1e-4 (the adapter's 1e-5), losses 1e-5 relative,
gradients 1e-4 abs / 1e-3 rel (f32 sums in another order); the EDM
functions 1e-6 relative.

The port's adapters on the six modulation linears of each block (the JAX
blocks have none): at their zero initial delta the port is the JAX module,
their lora_a gets no gradient and their lora_b gradient is scaling (A -
bound)^T times the JAX gradient of the frozen modulation weight; with
nonzero deltas the port matches the JAX module run on weights W + (alpha /
r)(A - bound) B (the same jit, other arguments). One adamw step of the
port's trainer on Anima: its loss, global norm and every factor and adapter
weight against adamw's first step on the clipped gradients, the adapter at
its own llm_adapter_lr.

Exact: the KeyMap against the JAX keymap_from_flax both ways; load_weights
of a prefixed file (the RoPE `seq` buffer and `_extra_state` skipped, a
missing or untaken key raising); the LoRA export (the JAX export's tensors
plus the modulation factors) and its re-import; the trained LLMAdapter
exported beside it and in a full model (the JAX exports carry neither) and
read back; the layout of a 14 B-shaped key listing read without any
[model] size; Cosmos-1's GeneralDIT names against upstream key strings
written out here.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import cosmos_predict2_model as jcm
from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models import keymaps as jkm
from diffusion_pipe_tpu.models import llm_adapter as jla
from diffusion_pipe_tpu.training import edm as jedm
from diffusion_pipe_tpu.training.optimizers import scale_updates_by_path
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu.training.train_state import predicate_from_config as jax_predicate
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import (cosmos_predict2_config, cosmos_predict2_state_dict,
                                              llm_adapter_state_dict)
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models.cosmos import convert_general_dit_sd
from diffusion_pipe_tpu_torch.models.cosmos_predict2 import cosmos_checkpoint_layout
from diffusion_pipe_tpu_torch.models.cosmos_predict2_model import (CosmosPredict2Config,
                                                                   CosmosPredict2Transformer,
                                                                   cosmos_rope_angles)
from diffusion_pipe_tpu_torch.models.layers import init_module_weights
from diffusion_pipe_tpu_torch.models.llm_adapter import (LLMAdapter, LLMAdapterConfig,
                                                         convert_llm_adapter)
from diffusion_pipe_tpu_torch.training import edm
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer, path_scales
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, random_params

KEY = jax.random.PRNGKey(17)
LR = 1e-3
MODULATION = "adaln_modulation"
LR_GROUPS = dict(self_attn_lr=2e-3, cross_attn_lr=3e-3, mlp_lr=4e-3, mod_lr=5e-3,
                 llm_adapter_lr=6e-3)


def cfg(family, **model):
    return {"save_every_n_epochs": 1,
            "model": {"type": family, "dtype": "float32", "_tiny": True, **model},
            "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
            "optimizer": {"type": "adamw", "lr": LR, "eps": 1e-2, "weight_decay": 0.01},
            "gradient_clipping": 1.0}


ANIMA_CFG = cfg("anima", llm_adapter_lr=2 * LR, multiscale_loss_weight=0.5)


def _batch(seed, frames=1, text=None):
    rng = np.random.default_rng(seed)
    out = {"latents": (rng.standard_normal((2, 16, frames, 8, 12)) * 0.5).astype(np.float32),
           "mask": (rng.random((2, 12, 20)) > 0.3).astype(np.float32)}
    if text == "t5_embed" or text == "prompt_embeds":
        out[text] = rng.standard_normal((2, 8, 32)).astype(np.float32)
    elif text == "anima":
        llm_mask = np.ones((2, 8), np.int32)
        llm_mask[1, 5:] = 0
        t5_mask = np.ones((2, 8), np.int32)
        t5_mask[0, 6:] = 0
        out.update(llm_hidden_states=rng.standard_normal((2, 8, 16)).astype(np.float32),
                   llm_mask=llm_mask, t5_input_ids=rng.integers(0, 64, (2, 8)).astype(np.int32),
                   t5_mask=t5_mask)
    return out


def _dit_inputs(frames, seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((2, 16, frames, 8, 12)).astype(np.float32),
                t=np.array([0.3, 0.8], np.float32),
                context=rng.standard_normal((2, 8, 32)).astype(np.float32),
                padding_mask=(rng.random((2, 1, frames, 8, 12)) > 0.5).astype(np.float32),
                target=rng.standard_normal((2, 16, frames, 8, 12)).astype(np.float32))


# adapter case -> (JAX LLMAdapterConfig.tiny overrides, llm_mask all zero); the
# target is 32 wide, so a 24-wide model has in_proj
ADAPTERS = {"cross_in_proj": (dict(model_dim=24), False),
            "self_attn_no_in_proj": (dict(self_attn=True), False),
            "empty_caption": (dict(self_attn=True), True)}


def _adapter_params(jcfg, seed):
    shapes = jax.eval_shape(jla.LLMAdapter(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, jcfg.source_dim)), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _adapter_inputs(empty, seed=41):
    rng = np.random.default_rng(seed)
    llm_mask = np.ones((2, 8), np.int32)
    llm_mask[0, 3:] = 0
    t5_mask = np.ones((2, 8), np.int32)
    t5_mask[1, 5:] = 0
    if empty:
        llm_mask[:] = 0
    return dict(hs=rng.standard_normal((2, 8, 16)).astype(np.float32),
                ids=rng.integers(0, 64, (2, 8)).astype(np.int32), t5_mask=t5_mask,
                llm_mask=llm_mask)


def _split(params, family):
    """(the leaves differentiated: the family's trainable ones and the
    frozen modulation weights, whose gradients the port's modulation
    adapters are held against; the rest)."""
    trainable = jax_predicate(cfg(family))
    return partition_params(params, lambda path, leaf: trainable(path, leaf) or (
        path[-1] == "kernel" and any(MODULATION in p for p in path)))


@functools.lru_cache(maxsize=None)
def reference():
    """Every JAX reference from one jit (see the module docstring)."""
    jp = {"cosmos_predict2": jax_model_class("cosmos_predict2")(cfg("cosmos_predict2")),
          "anima": jax_model_class("anima")(ANIMA_CFG),
          "cosmos": jax_model_class("cosmos")(cfg("cosmos"))}
    params = {f: random_params(p, seed=7 + i, lora_b_std=0.05)
              for i, (f, p) in enumerate(jp.items())}
    adapters = {}
    for name, (over, empty) in ADAPTERS.items():
        jcfg = jla.LLMAdapterConfig.tiny(target_dim=32, **over)
        adapters[name] = (jcfg, _adapter_params(jcfg, seed=len(adapters)), _adapter_inputs(empty))
    data = {"dit": {"image": _dit_inputs(1, 1), "video": _dit_inputs(2, 2)},
            "anima": _batch(3, text="anima"), "cosmos": _batch(4, frames=2, text="prompt_embeds"),
            "big": np.random.default_rng(5).standard_normal((2, 2, 16, 1, 120, 120)).astype(
                np.float32),
            "adapters": {k: v[2] for k, v in adapters.items()}}
    sigmas = np.array([0.01, 0.5, 3.0, 80.0], np.float32)

    def dit_loss(train, x, context, d, frozen):
        out = jp["cosmos_predict2"].model.apply(merge_params(train, frozen), x, d["t"],
                                                context, padding_mask=d["padding_mask"])
        return jnp.mean((out - d["target"]) ** 2), out

    def pipe_loss(family, train, batch, frozen):
        mi, target, mask = jp[family].prepare_inputs(KEY, batch)
        out = jp[family].forward(merge_params(train, frozen), dict(mi))
        return jp[family].loss_fn(out, target, mask), (mi, target, mask, out)

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(params, data):
        res = {"dit": {}}
        train, frozen = _split(params["cosmos_predict2"], "cosmos_predict2")
        for case, d in data["dit"].items():
            (loss, out), g = jax.value_and_grad(dit_loss, argnums=(0, 1, 2), has_aux=True)(
                train, d["x"], d["context"], d, frozen)
            res["dit"][case] = dict(out=out, loss=loss, grads=g[0], dx=g[1], dctx=g[2])
        for family in ("anima", "cosmos"):
            train, frozen = _split(params[family], family)
            (loss, aux), g = jax.value_and_grad(functools.partial(pipe_loss, family),
                                                has_aux=True)(train, data[family], frozen)
            mi, target, mask, out = aux
            _, n_key = jax.random.split(KEY)
            noise = jax.random.normal(n_key, data[family]["latents"].shape, jnp.float32)
            res[family] = dict(loss=loss, grads=g, mi=mi, target=target, mask=mask, out=out,
                               noise=noise)
        o, t = data["big"]
        res["multiscale"] = jp["anima"].loss_fn(o, t, None)
        res["edm"] = dict(scalings=jedm.edm_scalings(sigmas),
                          weights=jedm.per_sigma_loss_weights(sigmas),
                          quantile=jedm.sample_sigma(None, 3, quantile=0.3))
        ctx = data["cosmos"]["prompt_embeds"]
        res["sample"] = jp["cosmos"].sample(params["cosmos"], 96, 64, KEY, num_steps=3,
                                            prompt_embeds=ctx)
        res["sample_noise"] = jax.random.normal(KEY, (2, 16, 1, 8, 12), jnp.float32)
        res["adapters"] = {}
        for name, (jcfg, _, _) in adapters.items():
            d = data["adapters"][name]

            def adapter_loss(p):
                out = jla.LLMAdapter(jcfg).apply(p, d["hs"], d["ids"], target_mask=d["t5_mask"],
                                                 source_mask=d["llm_mask"])
                return jnp.sum(out ** 2), out

            (_, out), g = jax.value_and_grad(adapter_loss, has_aux=True)(params["adapters"][name])
            res["adapters"][name] = dict(out=out, grads=g)
        return res

    params["adapters"] = {k: v[1] for k, v in adapters.items()}
    res = jax.tree.map(np.asarray, run(params, data))
    return dict(jp=jp, params=jax.tree.map(np.asarray, params), data=data, res=res, run=run,
                adapter_configs={k: v[0] for k, v in adapters.items()}, sigmas=sigmas)


def port_pipeline(family, params, config=None):
    """The port's pipeline on the JAX weights, its modulation adapters at
    their init (A uniform, B zero)."""
    pipe = get_model_class(family)(config or cfg(family), device="cpu")
    pipe.model.to_empty(device="cpu")
    init_module_weights(pipe.model, torch.Generator().manual_seed(5))
    missing, unexpected = pipe.model.load_state_dict(cosmos_predict2_state_dict(params),
                                                     strict=False)
    assert not unexpected and missing and all(MODULATION in k and ".lora_" in k for k in missing)
    return pipe


def _check_grads(pipe, want_sd, atol=1e-4, rtol=1e-3):
    """Every port parameter with a gradient against the JAX gradients (port
    names, want_sd): the JAX module's adapter factors (and Anima's adapter)
    directly; the modulation adapters' lora_b against scaling (A - bound)^T
    times the JAX gradient of the frozen weight, their lora_a at zero."""
    got = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    assert got
    for n, p in got.items():
        if MODULATION in n and ".lora_" in n:
            owner = n.rsplit(".", 1)[0]
            lin = pipe.model.get_submodule(owner)
            if n.endswith("lora_a"):
                assert not p.grad.any(), n
                continue
            a = (lin.lora_a - lin.lora_bound).detach().numpy()
            want = lin.lora_scaling * a.T @ want_sd[owner + ".weight"].numpy().T
        else:
            want = want_sd[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, atol=atol, rtol=rtol, err_msg=n)
    return got


@pytest.mark.parametrize("case", ["image", "video"])
def test_dit_forward_and_grads_match(case):
    """The MiniTrainDIT with a nonzero padding mask: output, loss, the
    input gradients and every adapter gradient."""
    ref = reference()
    want = ref["res"]["dit"][case]
    d = {k: torch.from_numpy(v) for k, v in ref["data"]["dit"][case].items()}
    pipe = port_pipeline("cosmos_predict2", ref["params"]["cosmos_predict2"])
    assert pipe.cp_config == cosmos_predict2_config(ref["jp"]["cosmos_predict2"].cp_config)
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(n))
    x, ctx = d["x"].requires_grad_(), d["context"].requires_grad_()
    out = pipe.model(x, d["t"], ctx, padding_mask=d["padding_mask"])
    loss = torch.mean((out - d["target"]) ** 2)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), want["out"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), want["dx"], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(ctx.grad.numpy(), want["dctx"], atol=1e-4, rtol=1e-3)
    got = _check_grads(pipe, cosmos_predict2_state_dict(want["grads"]))
    # 10 attention and MLP linears and 6 modulation linears a block
    assert len(got) == 2 * 16 * 2


def test_rope_angles_with_fps_modulation():
    """cosmos_rope_angles against the JAX function, fps-modulated time and
    NTK ratios other than 1, at head dim 128 (dims 42 / 42 / 44)."""
    over = dict(model_channels=256, num_heads=2, rope_enable_fps_modulation=True,
                rope_h_extrapolation_ratio=2.0, rope_w_extrapolation_ratio=3.0,
                rope_t_extrapolation_ratio=1.5)
    jcfg = jcm.CosmosPredict2Config.tiny(**over)
    port = CosmosPredict2Config.tiny(**over)
    for t, fps in ((3, 30.0), (1, 30.0), (4, None)):
        want = jcm.cosmos_rope_angles(jcfg, t, 4, 5, fps)
        got = cosmos_rope_angles(port, t, 4, 5, fps)
        assert got.dtype == torch.float32 and got.shape == (t * 20, 128)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(ADAPTERS))
def test_llm_adapter_matches(case):
    """The LLMAdapter alone: output and every parameter gradient. With
    llm_mask all zero (an empty caption) every cross-attention row is the
    uniform softmax, as in JAX: the mean of v over all keys."""
    ref = reference()
    want = ref["res"]["adapters"][case]
    jcfg = ref["adapter_configs"][case]
    port = LLMAdapter(LLMAdapterConfig(**{f.name: getattr(jcfg, f.name)
                                          for f in dataclasses.fields(LLMAdapterConfig)
                                          if f.name not in ("dtype", "param_dtype")}))
    assert hasattr(port, "in_proj") == (jcfg.model_dim != jcfg.target_dim)
    assert hasattr(port.blocks[0], "self_attn") == jcfg.self_attn
    port.load_state_dict(llm_adapter_state_dict(ref["params"]["adapters"][case]))
    d = {k: torch.from_numpy(v) for k, v in ref["data"]["adapters"][case].items()}
    out = port(d["hs"], d["ids"], target_mask=d["t5_mask"], source_mask=d["llm_mask"])
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want["out"], atol=1e-5, rtol=1e-5)
    grads = llm_adapter_state_dict(want["grads"])
    assert set(grads) == {n for n, _ in port.named_parameters()}
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=n)
    if case == "empty_caption":
        attn = port.blocks[0].cross_attn
        x = torch.randn((2, 8, jcfg.model_dim))
        with torch.no_grad():
            got = attn(x, d["hs"], (torch.ones(8, 8), torch.zeros(8, 8)),
                       (torch.ones(8, 8), torch.zeros(8, 8)), d["llm_mask"])
            v = attn.v_proj(d["hs"]).mean(dim=1, keepdim=True).expand(-1, 8, -1)
            np.testing.assert_allclose(got.numpy(), attn.o_proj(v).numpy(), atol=1e-5)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}


def test_anima_pipeline_matches():
    """Anima from its prepare_inputs (the JAX t and noise): the noised
    latents, t, target and latent mask, the output through the adapter
    (its padded rows zeroed) and the DiT, the loss, every gradient."""
    ref = reference()
    want = ref["res"]["anima"]
    pipe = port_pipeline("anima", ref["params"]["anima"], ANIMA_CFG)
    pipe.model.requires_grad_(False)
    trainable = pipe.trainable_predicate()
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(trainable(n))
    inputs, target, mask = pipe.prepare_inputs(_torch_batch(ref["data"]["anima"]),
                                               noise=torch.tensor(want["noise"]),
                                               t=torch.from_numpy(want["mi"]["t"]))
    np.testing.assert_allclose(inputs["x"].numpy(), want["mi"]["x"], atol=1e-6)
    np.testing.assert_array_equal(target.numpy(), want["target"])
    np.testing.assert_array_equal(mask.numpy(), want["mask"])
    for k in ("llm_mask", "t5_input_ids", "t5_mask"):
        np.testing.assert_array_equal(inputs[k].numpy(), want["mi"][k])
    out = pipe.forward(inputs)
    np.testing.assert_allclose(out.detach().numpy(), want["out"], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    got = _check_grads(pipe, cosmos_predict2_state_dict(want["grads"]))
    assert sum(n.startswith("llm_adapter.") for n in got) == len(
        list(pipe.model.llm_adapter.parameters()))


def test_multiscale_loss_matches():
    """multiscale_loss_weight 0.5 on a 120 x 120 latent (960 px clears
    921.6): the masked MSE and one 2 x 2 average-pooled term, over 1.5."""
    ref = reference()
    pipe = get_model_class("anima")(ANIMA_CFG, device="cpu")
    o, t = (torch.from_numpy(a) for a in ref["data"]["big"])
    got = pipe.loss_fn(o, t, None)
    np.testing.assert_allclose(got.item(), ref["res"]["multiscale"], rtol=1e-5)
    assert abs(got.item() - torch.mean((o - t) ** 2).item()) > 1e-3


def test_edm_functions_and_cosmos_pipeline_match():
    """The EDM scalings and weights, the quantile's sigma, then Cosmos-1
    from its prepare_inputs (the JAX sigma and noise; 2 latent frames):
    the net input c_in x_t, c_noise, x_t, the clean target, the x0
    prediction, the weighted loss and every gradient."""
    ref = reference()
    res = ref["res"]
    sig = torch.from_numpy(ref["sigmas"])
    for got, want in zip(edm.edm_scalings(sig), res["edm"]["scalings"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(edm.per_sigma_loss_weights(sig).numpy(), res["edm"]["weights"],
                               rtol=1e-6)
    np.testing.assert_allclose(edm.sample_sigma(3, quantile=0.3).numpy(), res["edm"]["quantile"],
                               rtol=1e-6)
    want = res["cosmos"]
    pipe = port_pipeline("cosmos", ref["params"]["cosmos"])
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(n))
    inputs, target, mask = pipe.prepare_inputs(_torch_batch(ref["data"]["cosmos"]),
                                               noise=torch.tensor(want["noise"]),
                                               t=torch.from_numpy(want["mi"]["_sigma"]))
    for k in ("x", "t", "_x_t", "_sigma"):
        np.testing.assert_allclose(inputs[k].numpy(), want["mi"][k], atol=1e-6, rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(target.numpy(), want["target"])
    x0, sigma = pipe.forward(inputs)
    np.testing.assert_allclose(x0.detach().numpy(), want["out"][0], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn((x0, sigma), target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    _check_grads(pipe, cosmos_predict2_state_dict(want["grads"]))


def test_karras_sampler_matches():
    """Three EDM Euler steps over the Karras schedule from the JAX noise."""
    ref = reference()
    pipe = port_pipeline("cosmos", ref["params"]["cosmos"])
    got = pipe.sample(width=96, height=64, noise=torch.from_numpy(ref["res"]["sample_noise"]),
                      num_steps=3,
                      prompt_embeds=torch.from_numpy(ref["data"]["cosmos"]["prompt_embeds"]))
    np.testing.assert_allclose(got.numpy(), ref["res"]["sample"], atol=1e-4, rtol=1e-4)


def test_trainable_set_and_lr_groups_match():
    """Anima's trainable set under [adapter] (the factors and every
    llm_adapter weight) against the JAX predicate, the port adding the
    modulation factors; the LR groups (self_attn, cross_attn, mlp_, the
    modulations' mod_lr, llm_adapter_lr, the last match winning) against
    lr_scale_map and scale_updates_by_path, leaf by leaf."""
    ref = reference()
    config = cfg("anima", **LR_GROUPS)
    jpipe = jax_model_class("anima")(config)
    params = ref["params"]["anima"]
    jtrain = cosmos_predict2_state_dict(partition_params(params, jax_predicate(config))[0])
    pipe = get_model_class("anima")(config, device="cpu")
    names = [n for n, _ in pipe.model.named_parameters() if pipe.trainable_predicate()(n)]
    extra = set(names) - set(jtrain)
    assert set(jtrain) <= set(names) and extra and all(MODULATION in n for n in extra)
    assert any(n.startswith("llm_adapter.") for n in jtrain)
    full_ft = get_model_class("anima")({k: v for k, v in config.items() if k != "adapter"},
                                       device="cpu").trainable_predicate()
    assert all(full_ft(n) for n, _ in pipe.model.named_parameters())
    predict2 = get_model_class("cosmos_predict2")(cfg("cosmos_predict2"), device="cpu")
    assert predict2.trainable_predicate() is lora_predicate
    scales = pipe.lr_scale_map(LR)
    assert scales == jpipe.lr_scale_map(LR)
    ones = jax.tree.map(lambda a: np.ones((), np.float32), params["params"])
    jscaled = scale_updates_by_path(scales).update({"params": ones}, None)[0]
    want = {k: float(v) for k, v in cosmos_predict2_state_dict(
        jax.tree.map(lambda a: np.full((1, 1), a), jscaled)).items()}
    all_names = [n for n, _ in pipe.model.named_parameters()]
    got = dict(zip(all_names, path_scales(all_names, scales)))
    for n in want:
        assert got[n] == want[n], n
    assert got["blocks.1.adaln_modulation_mlp_2.weight"] == 5.0
    assert got["llm_adapter.blocks.0.cross_attn.q_proj.weight"] == 6.0
    assert got["blocks.0.self_attn_q.weight"] == 2.0 and got["final_adaln_1.weight"] == 5.0


def _adamw_first_step(p0, g, lr, wd=0.01, eps=1e-2):
    """optax adamw's first update from zero moments: p - lr (g / (|g| + eps)
    + wd p), the decay on tensors of more than one dimension."""
    return p0 - lr * (g / (np.abs(g) + eps) + (wd * p0 if p0.ndim > 1 else 0))


def test_anima_trainer_step_matches():
    """One step of the port's trainer on Anima (adamw, clip 1.0) from the JAX
    t and noise: the loss, the global norm, every factor and adapter
    weight against adamw's first step on the clipped JAX gradients (the
    adapter at llm_adapter_lr = 2 lr); nothing else moves."""
    ref = reference()
    want = ref["res"]["anima"]
    pipe = port_pipeline("anima", ref["params"]["anima"], ANIMA_CFG)
    sd = pipe.model.state_dict()
    state = init_train_state(pipe, get_optimizer(ANIMA_CFG, lr_scales=pipe.lr_scale_map(LR)),
                             torch.Generator().manual_seed(0), pipe.trainable_predicate(),
                             state_dict=sd)
    start = {n: p.detach().clone().numpy() for n, p in state.trainable.items()}
    frozen = {k: v.clone() for k, v in pipe.model.state_dict().items() if k not in start}
    jgrads = cosmos_predict2_state_dict(want["grads"])
    grads = {}
    for n in state.trainable:
        if MODULATION in n and ".lora_" in n:
            owner = n.rsplit(".", 1)[0]
            lin = pipe.model.get_submodule(owner)
            a = start[owner + ".lora_a"] - lin.lora_bound
            grads[n] = (np.zeros_like(start[n]) if n.endswith("lora_a") else
                        lin.lora_scaling * a.T @ jgrads[owner + ".weight"].numpy().T)
        else:
            grads[n] = jgrads[n].numpy()
    m = make_train_step(pipe, gradient_clipping=1.0)(
        state, _torch_batch(ref["data"]["anima"]), noise=torch.tensor(want["noise"]),
        t=torch.from_numpy(want["mi"]["t"]))
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    np.testing.assert_allclose(m["loss"].item(), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), norm, rtol=1e-4)
    clip = min(1.0, 1.0 / (norm + 1e-6))
    for name, p in state.trainable.items():
        lr = LR * (2.0 if name.startswith("llm_adapter.") else 1.0)
        g = grads[name] * clip
        want_p, got, zero = _adamw_first_step(start[name], g, lr), p.detach().numpy(), g == 0
        # gradients to 1e-4 move g / (|g| + eps) by up to 1e-2
        np.testing.assert_allclose(got[~zero], want_p[~zero], atol=2e-2 * lr, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(got[zero], want_p[zero], atol=0, rtol=1e-6, err_msg=name)
    after = pipe.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in frozen.items())


def test_modulation_adapters_merge_into_the_jax_weights():
    """Nonzero modulation deltas: the port's output equals the JAX module's
    on modulation weights W + (alpha / r)(A - bound) B."""
    ref = reference()
    params = jax.tree.map(np.array, ref["params"])
    pipe = port_pipeline("cosmos_predict2", params["cosmos_predict2"])
    gen = torch.Generator().manual_seed(7)
    blocks = params["cosmos_predict2"]["params"]["blocks"]
    with torch.no_grad():
        for i, block in enumerate(pipe.model.blocks):
            for name, lin in block.named_children():
                if name.startswith(MODULATION):
                    lin.lora_b.normal_(0.0, 0.05, generator=gen)
                    delta = lin.lora_scaling * (lin.lora_a - lin.lora_bound) @ lin.lora_b
                    blocks[name]["kernel"][i] += delta.numpy()
        d = {k: torch.from_numpy(v) for k, v in ref["data"]["dit"]["image"].items()}
        out = pipe.model(d["x"], d["t"], d["context"], padding_mask=d["padding_mask"])
    merged = ref["run"](params, ref["data"])["dit"]["image"]["out"]
    np.testing.assert_allclose(out.numpy(), np.asarray(merged), atol=1e-4, rtol=1e-4)
    assert np.abs(np.asarray(merged) - ref["res"]["dit"]["image"]["out"]).max() > 1e-3


def _jax_checkpoint(family):
    ref = reference()
    jpipe = ref["jp"][family]
    frozen = partition_params(ref["params"][family], jax_predicate(cfg(family)))[1]
    frozen = {"params": {k: v for k, v in frozen["params"].items() if k != "llm_adapter"}}
    return ref, jkm.keymap_from_flax(frozen, jpipe.keymap(), jpipe.cp_config)


@pytest.mark.parametrize("family", ["cosmos_predict2", "cosmos"])
def test_keymap_matches_jax_both_ways(family):
    """The port's KeyMap writes the JAX keymap_from_flax's names and tensors
    and reads them back."""
    ref, sd = _jax_checkpoint(family)
    pipe = get_model_class(family)(cfg(family), device="cpu")
    weights = {k: v for k, v in cosmos_predict2_state_dict(ref["params"][family]).items()
               if "lora" not in k}
    out = tkm.keymap_from_state_dict(weights, pipe.keymap(), pipe.cp_config)
    assert set(out) == set(sd)
    for k, v in sd.items():
        assert torch.equal(out[k], torch.from_numpy(np.ascontiguousarray(v))), k
    back = tkm.keymap_to_state_dict(out, pipe.keymap(), pipe.cp_config)
    assert set(back) == set(weights) and all(torch.equal(back[k], weights[k]) for k in back)
    assert "blocks.1.adaln_modulation_cross_attn.2.weight" in sd
    assert sd["x_embedder.proj.1.weight"].shape == (64, 17 * 4)


def test_load_export_reimport(tmp_path):
    """A `net.`-prefixed file with the RoPE seq buffer and an _extra_state
    blob loads bit for bit; without a key, or with one the model does not
    take, it raises. The LoRA goes out with the JAX export's tensors plus
    the modulation factors, and comes back bit for bit."""
    ref, ck = _jax_checkpoint("cosmos_predict2")
    sd = {"net." + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ck.items()}
    extras = {"net.pos_embedder.seq": torch.arange(4.0),
              "net.blocks.0.self_attn._extra_state": torch.zeros(3, dtype=torch.uint8)}
    path = tmp_path / "predict2.safetensors"
    safetensors_io.save_file({**sd, **extras}, str(path))
    config = cfg("cosmos_predict2", transformer_path=str(path))
    pipe = get_model_class("cosmos_predict2")(config, device="cpu")
    loaded = pipe.load_weights()
    weights = cosmos_predict2_state_dict(ref["params"]["cosmos_predict2"])
    assert set(loaded) == {k for k in weights if "lora" not in k}
    assert all(torch.equal(loaded[k], weights[k]) for k in loaded)
    for name, bad in (("missing", {k: v for k, v in sd.items() if "mlp.layer2" not in k}),
                      ("untaken", {**sd, "net.blocks.0.self_attn.x_proj.weight": torch.zeros(1)})):
        safetensors_io.save_file(bad, str(tmp_path / f"{name}.safetensors"))
        broken = get_model_class("cosmos_predict2")(
            cfg("cosmos_predict2", transformer_path=str(tmp_path / f"{name}.safetensors")),
            device="cpu")
        with pytest.raises(KeyError, match="layer2" if name == "missing" else "x_proj"):
            broken.load_weights()

    port = port_pipeline("cosmos_predict2", ref["params"]["cosmos_predict2"])
    factors = {k: v.detach() for k, v in port.model.state_dict().items() if lora_predicate(k)}
    port.save_adapter(tmp_path / "adapter", factors)
    saved = safetensors_io.load_file(tmp_path / "adapter" / "adapter_model.safetensors")
    jpipe = ref["jp"]["cosmos_predict2"]
    jtrain = partition_params(ref["params"]["cosmos_predict2"],
                              jax_predicate(cfg("cosmos_predict2")))[0]
    jax_export = jkm.export_lora_keymap(jtrain, jpipe.keymap(), jpipe.cp_config)
    for k, v in jax_export.items():
        assert torch.equal(saved[k], torch.from_numpy(np.ascontiguousarray(v))), k
    extra = {k for k in saved if k.endswith(".lora_A.weight")} - set(jax_export)
    assert extra == {f"diffusion_model.blocks.{i}.adaln_modulation_{s}.{j}.lora_A.weight"
                     for i in range(2) for s in ("self_attn", "cross_attn", "mlp")
                     for j in (1, 2)}
    assert sum(k.endswith(".alpha") for k in saved) == 2 * 16
    back = port.load_adapter(tmp_path / "adapter")
    assert set(back) == set(factors) and all(torch.equal(back[k], factors[k]) for k in back)


def test_anima_exports_its_trained_adapter(tmp_path):
    """The JAX exports of a trained tiny Anima (the LoRA and the full model)
    carry no llm_adapter tensor; the port writes the adapter beside the
    LoRA (llm_adapter.safetensors) and inside the full model, under the
    llm_adapter.* names that init_from_existing and load_weights (also as
    llm_adapter_path) read back bit for bit."""
    ref = reference()
    params = ref["params"]["anima"]
    jpipe = ref["jp"]["anima"]
    jtrain, jfrozen = partition_params(params, jax_predicate(ANIMA_CFG))
    assert jtrain["params"]["llm_adapter"] is not None
    jax_lora = jkm.export_lora_keymap(jtrain, jpipe.keymap(), jpipe.cp_config)
    jax_full = jkm.keymap_from_flax(params, jpipe.keymap(), jpipe.cp_config)
    assert not any("llm_adapter" in k for k in (*jax_lora, *jax_full))

    pipe = port_pipeline("anima", params, ANIMA_CFG)
    trainable = {n: p.detach() for n, p in pipe.model.named_parameters()
                 if pipe.trainable_predicate()(n)}
    adapter = {n: v for n, v in trainable.items() if n.startswith("llm_adapter.")}
    pipe.save_adapter(tmp_path / "lora", trainable)
    file = safetensors_io.load_file(tmp_path / "lora" / "llm_adapter.safetensors")
    assert len(file) == len(adapter) and "llm_adapter.blocks.0.norm_mlp.weight" in file
    back = pipe.load_adapter(tmp_path / "lora")
    assert set(back) == set(trainable) and all(torch.equal(back[k], trainable[k]) for k in back)
    for bad, error in (({"llm_adapter.blocks.0.extra.weight": torch.zeros(1)}, KeyError),
                       ({"llm_adapter.norm.bias": torch.zeros(1)}, ValueError)):
        with pytest.raises(error, match="extra" if error is KeyError else "LayerNorm"):
            convert_llm_adapter({**file, **bad}, pipe.adapter_config)

    pipe.save_model(tmp_path / "full", pipe.model)
    full = safetensors_io.load_file(tmp_path / "full" / "model.safetensors")
    assert set(full) == set(jax_full) | set(file)
    for config in (cfg("anima", transformer_path=str(tmp_path / "full" / "model.safetensors")),
                   cfg("anima", transformer_path=str(tmp_path / "full" / "model.safetensors"),
                       llm_adapter_path=str(tmp_path / "lora" / "llm_adapter.safetensors"))):
        loaded = get_model_class("anima")(config, device="cpu").load_weights()
        weights = {k: v for k, v in pipe.model.state_dict().items() if "lora" not in k}
        assert set(loaded) == set(weights)
        assert all(torch.equal(loaded[k], weights[k]) for k in loaded)


def _meta_checkpoint(cfg_):
    """The Predict2-named checkpoint of a model of cfg_ as meta tensors."""
    with torch.device("meta"):
        model = CosmosPredict2Transformer(cfg_)
    from diffusion_pipe_tpu_torch.models.cosmos_predict2 import cosmos_predict2_keymap

    return tkm.keymap_from_state_dict(model.state_dict(), cosmos_predict2_keymap(cfg_), cfg_)


def test_a_14b_layout_loads_without_model_sizes(monkeypatch):
    """A 14 B-shaped key listing (5,120 wide, 36 blocks, 40 heads of 128,
    `net.`-prefixed, as meta tensors) sets the model's layout with no
    [model] size; a [model] size that disagrees with it raises."""
    big = CosmosPredict2Config(model_channels=5120, num_blocks=36, num_heads=40)
    sd = {"net." + k: v for k, v in _meta_checkpoint(big).items()}
    sd["net.pos_embedder.seq"] = torch.empty(4, device="meta")
    assert sd["net.blocks.35.self_attn.q_norm.weight"].shape == (128,)
    monkeypatch.setattr(tkm, "load_sd_for_pipeline", lambda pipeline: dict(sd))
    config = {"model": {"type": "cosmos_predict2", "transformer_path": "unused"}}
    pipe = get_model_class("cosmos_predict2")(config, device="cpu")
    assert pipe.cp_config.model_channels == 2048
    loaded = pipe.load_weights()
    c = pipe.cp_config
    assert (c.model_channels, c.num_blocks, c.num_heads, c.crossattn_emb_channels,
            c.adaln_lora_dim, c.use_adaln_lora, c.in_channels, c.mlp_ratio) == (
        5120, 36, 40, 1024, 256, True, 16, 4.0)
    assert set(loaded) == set(pipe.model.state_dict()) - {
        k for k in pipe.model.state_dict() if "lora" in k}
    assert all(loaded[k].shape == v.shape for k, v in pipe.model.state_dict().items()
               if k in loaded)
    assert cosmos_checkpoint_layout(
        {k[4:]: v for k, v in sd.items()}, big)["num_blocks"] == 36
    config["model"]["num_blocks"] = 28
    with pytest.raises(KeyError, match="num_blocks"):
        get_model_class("cosmos")(config, device="cpu").load_weights()


# Cosmos-1's GeneralDIT names of block {i}, as the released checkpoints
# spell them, and the Predict2 names they load as
GENERAL_DIT = {
    "net.blocks.block{i}.blocks.0.adaLN_modulation.1.weight":
        "blocks.{i}.adaln_modulation_self_attn.1.weight",
    "net.blocks.block{i}.blocks.0.adaLN_modulation.2.weight":
        "blocks.{i}.adaln_modulation_self_attn.2.weight",
    "net.blocks.block{i}.blocks.0.block.attn.to_q.0.weight": "blocks.{i}.self_attn.q_proj.weight",
    "net.blocks.block{i}.blocks.0.block.attn.to_q.1.weight": "blocks.{i}.self_attn.q_norm.weight",
    "net.blocks.block{i}.blocks.0.block.attn.to_k.0.weight": "blocks.{i}.self_attn.k_proj.weight",
    "net.blocks.block{i}.blocks.0.block.attn.to_k.1.weight": "blocks.{i}.self_attn.k_norm.weight",
    "net.blocks.block{i}.blocks.0.block.attn.to_v.0.weight": "blocks.{i}.self_attn.v_proj.weight",
    "net.blocks.block{i}.blocks.0.block.attn.to_out.0.weight":
        "blocks.{i}.self_attn.output_proj.weight",
    "net.blocks.block{i}.blocks.1.adaLN_modulation.1.weight":
        "blocks.{i}.adaln_modulation_cross_attn.1.weight",
    "net.blocks.block{i}.blocks.1.adaLN_modulation.2.weight":
        "blocks.{i}.adaln_modulation_cross_attn.2.weight",
    "net.blocks.block{i}.blocks.1.block.attn.to_q.0.weight": "blocks.{i}.cross_attn.q_proj.weight",
    "net.blocks.block{i}.blocks.1.block.attn.to_q.1.weight": "blocks.{i}.cross_attn.q_norm.weight",
    "net.blocks.block{i}.blocks.1.block.attn.to_k.0.weight": "blocks.{i}.cross_attn.k_proj.weight",
    "net.blocks.block{i}.blocks.1.block.attn.to_k.1.weight": "blocks.{i}.cross_attn.k_norm.weight",
    "net.blocks.block{i}.blocks.1.block.attn.to_v.0.weight": "blocks.{i}.cross_attn.v_proj.weight",
    "net.blocks.block{i}.blocks.1.block.attn.to_out.0.weight":
        "blocks.{i}.cross_attn.output_proj.weight",
    "net.blocks.block{i}.blocks.2.adaLN_modulation.1.weight":
        "blocks.{i}.adaln_modulation_mlp.1.weight",
    "net.blocks.block{i}.blocks.2.adaLN_modulation.2.weight":
        "blocks.{i}.adaln_modulation_mlp.2.weight",
    "net.blocks.block{i}.blocks.2.block.layer1.weight": "blocks.{i}.mlp.layer1.weight",
    "net.blocks.block{i}.blocks.2.block.layer2.weight": "blocks.{i}.mlp.layer2.weight",
}
GENERAL_DIT_TOP = {
    "net.x_embedder.proj.1.weight": "x_embedder.proj.1.weight",
    "net.t_embedder.1.linear_1.weight": "t_embedder.1.linear_1.weight",
    "net.t_embedder.1.linear_2.weight": "t_embedder.1.linear_2.weight",
    "net.affline_norm.weight": "t_embedding_norm.weight",
    "net.final_layer.adaLN_modulation.1.weight": "final_layer.adaln_modulation.1.weight",
    "net.final_layer.adaLN_modulation.2.weight": "final_layer.adaln_modulation.2.weight",
    "net.final_layer.linear.weight": "final_layer.linear.weight",
}


def test_general_dit_names(tmp_path):
    """Cosmos-1's GeneralDIT names (written out above) convert to Predict2's,
    the transformer-engine _extra_state blobs and the RoPE seq buffer
    skipped; such a file loads into the tiny Cosmos-1 bit for bit. A block
    key that maps to nothing raises, naming it."""
    ref, ck = _jax_checkpoint("cosmos")
    names = {k.format(i=i): v.format(i=i) for i in range(2) for k, v in GENERAL_DIT.items()}
    names.update(GENERAL_DIT_TOP)
    assert set(names.values()) == set(ck)
    sd = {k: torch.from_numpy(np.ascontiguousarray(ck[v])) for k, v in names.items()}
    sd["net.blocks.block0.blocks.0.block.attn._extra_state"] = torch.zeros(2, dtype=torch.uint8)
    sd["net.pos_embedder.seq"] = torch.arange(3.0)
    conv = convert_general_dit_sd(sd)
    assert set(conv) == set(ck) and all(torch.equal(conv[v], sd[k]) for k, v in names.items())
    path = tmp_path / "general_dit.safetensors"
    safetensors_io.save_file(sd, str(path))
    loaded = get_model_class("cosmos")(cfg("cosmos", transformer_path=str(path)),
                                       device="cpu").load_weights()
    weights = cosmos_predict2_state_dict(ref["params"]["cosmos"])
    assert set(loaded) == {k for k in weights if "lora" not in k}
    assert all(torch.equal(loaded[k], weights[k]) for k in loaded)
    for bad in ("net.blocks.block0.blocks.3.adaLN_modulation.1.weight",
                "net.blocks.block1.blocks.0.block.attn.to_x.0.weight",
                "net.blocks.block1.blocks.2.block.layer3.weight"):
        with pytest.raises(KeyError, match=bad.replace(".", r"\.")):
            convert_general_dit_sd({**sd, bad: torch.zeros(1)})
