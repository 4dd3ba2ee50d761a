"""Tiny Flux in the port vs the JAX package, on the same weights and draws.

The `_tiny` config (2 double + 2 single blocks, 4 heads of 32, f32) with
LoRA rank 4. Weights are seeded numpy draws on the JAX parameter structure
(tests/torch_port_helpers.py), with LoRA B nonzero so the adapters
contribute and every factor gets a gradient; they cross over through
interop.py. The noise and t come from the JAX key, as the JAX prepare_inputs
draws them, and are handed to the port. The reference model is the JAX
package's submodules composed with SiLU applied once to the timestep
embedding, as diffusers and BFL compute Flux (torch_port_helpers.
flux_one_silu, which one_silu makes the JAX pipeline's forward): the JAX
FluxTransformer applies it twice, and its output differs (checked). Tolerances: 1e-5 on prepare_inputs
(the same f32 arithmetic), 1e-4 on the output and 1e-4 abs / 1e-3 rel on
the LoRA grads (four blocks of f32 matmuls summed in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.training import flow as jflow
from diffusion_pipe_tpu.training import losses as jlosses
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu.training.trainer import make_loss_fn
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models.layers import LoraDense
from diffusion_pipe_tpu_torch.training import flow as tflow
from diffusion_pipe_tpu_torch.training import losses as tlosses
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from diffusion_pipe_tpu_torch.training.trainer import init_train_state
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import (JAX_FAST_COMPILE, jax_draws, jax_initial_state, one_silu,
                                random_params, tiny_batch, tiny_flux_config)

KEY = jax.random.PRNGKey(4)
PREP_KEY = jax.random.PRNGKey(3)


def masked_batch():
    """The tiny batch with a loss mask and Kontext control latents."""
    batch = tiny_batch(11)
    rng = np.random.default_rng(13)
    batch["mask"] = (rng.random((2, 12, 20)) > 0.5).astype(np.float32)
    batch["control_latents"] = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_side():
    """JAX pipeline, weights, and in one jit its forward, loss and LoRA
    grads at KEY, and its prepare_inputs of masked_batch() at PREP_KEY."""
    cfg = tiny_flux_config()
    pipeline = one_silu(jax_model_class("flux")(cfg))
    params = random_params(pipeline, seed=5, lora_b_std=0.05)
    jbatch = {k: jnp.asarray(v) for k, v in tiny_batch(11).items()}
    jmasked = {k: jnp.asarray(v) for k, v in masked_batch().items()}
    trainable, frozen = partition_params(params, jax_lora)

    def loss_fn(trainable):  # make_loss_fn's loss, with its output
        inputs, target, mask = pipeline.prepare_inputs(KEY, jbatch)
        out = pipeline.forward(merge_params(trainable, frozen), inputs)
        return pipeline.loss_fn(out, target, mask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(trainable):
        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        whole = pipeline.model.apply(params, **pipeline.prepare_inputs(KEY, jbatch)[0])
        return out, loss, grads, pipeline.prepare_inputs(PREP_KEY, jmasked), whole

    out, loss, grads, prep, whole = run(trainable)
    ref = dict(out=np.asarray(out), loss=float(loss), whole=np.asarray(whole),
               grads=jax_to_state_dict(jax.tree.map(np.asarray, grads)),
               prep=jax.tree.map(np.asarray, prep))
    return cfg, pipeline, params, ref


def _port(cfg, params):
    pipeline = get_model_class("flux")(cfg, device="cpu")
    pipeline.init_params(torch.Generator().manual_seed(0))
    pipeline.model.load_state_dict(jax_to_state_dict(params))
    return pipeline


def test_prepare_inputs_matches(jax_side):
    """Including a loss mask (resized to the latents and packed) and Kontext
    control latents appended to the image sequence."""
    cfg, jpipe, params, ref = jax_side
    batch = masked_batch()
    j_inputs, j_target, j_mask = ref["prep"]
    noise, t = jax_draws(jpipe, PREP_KEY, batch)
    pipe = _port(cfg, params)
    t_inputs, t_target, t_mask = pipe.prepare_inputs(
        {k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise, t=t)
    np.testing.assert_allclose(t_target.numpy(), np.asarray(j_target), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    for name in ("hidden_states", "encoder_hidden_states", "pooled_projections",
                 "timestep", "img_ids", "txt_ids", "guidance"):
        np.testing.assert_allclose(t_inputs[name].numpy(), np.asarray(j_inputs[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert t_inputs["img_seq_len"] == j_inputs["img_seq_len"]


def test_jax_module_applies_silu_twice(jax_side):
    """The reference of these tests is the JAX package's submodules composed
    with SiLU applied once to the timestep embedding (torch_port_helpers.
    flux_one_silu); the JAX FluxTransformer applies it twice (before its
    blocks, which apply it again). Its whole output differs from the
    composition by far more than the port's 1e-4 tolerance, so a port that
    went back to two SiLUs fails test_forward_and_lora_grads_match."""
    _, _, _, ref = jax_side
    assert np.abs(ref["whole"] - ref["out"]).max() > 1e-2
    assert not np.allclose(ref["whole"], ref["out"], atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_lora_grads_match(jax_side, remat):
    """Output and every LoRA gradient; the port runs with and without
    per-block activation checkpointing (the JAX side without)."""
    cfg, jpipe, params, ref = jax_side
    batch = tiny_batch(11)
    pipe = _port(dict(cfg, activation_checkpointing=remat), params)
    noise, t = jax_draws(jpipe, KEY, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_inputs, target, mask = pipe.prepare_inputs(tbatch, noise=noise, t=t)
    for name, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(name))
    out = pipe.forward(t_inputs)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    lora = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    assert set(lora) == set(ref["grads"]) and len(lora) == 80
    for name, p in lora.items():
        np.testing.assert_allclose(p.grad.numpy(), ref["grads"][name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("dist", [
    {}, {"shift": 3.0}, {"flux_shift": True, "sigmoid_scale": 1.5},
    {"timestep_sample_method": "uniform", "min_t": 0.1, "max_t": 0.8},
    {"shift": 2.0, "min_t": 0.2},
])
def test_timestep_quantiles_match(dist):
    """The inverse-CDF path of sample_timesteps (eval quantiles, and the
    shape of every draw), shift and truncation included; 1e-6."""
    jd = jflow.TimestepDistribution.from_model_config(dist)
    td = tflow.TimestepDistribution.from_model_config(dist)
    quantiles = (0.1, 0.5, 0.9)
    refs = jax.jit(lambda key: [
        jflow.sample_timesteps(key, 3, jd, quantile=q, image_seq_len=1024) for q in quantiles],
        compiler_options=JAX_FAST_COMPILE)(jax.random.PRNGKey(0))
    for q, j in zip(quantiles, refs):
        t = tflow.sample_timesteps(3, td, quantile=q, image_seq_len=1024)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("loss_cfg", [{}, {"huber_delta": 0.5}, {"smooth_l1_beta": 0.3}])
def test_losses_match(loss_cfg):
    rng = np.random.default_rng(2)
    out, target = (rng.standard_normal((2, 16, 8)).astype(np.float32) for _ in range(2))
    mask = (rng.random((2, 16, 8)) > 0.3).astype(np.float32)
    w = rng.random(2).astype(np.float32)
    kw_j = jlosses.loss_config_from_model_config(loss_cfg)
    kw_t = tlosses.loss_config_from_model_config(loss_cfg)
    assert kw_j == kw_t
    j = jlosses.masked_loss(out, target, mask, per_example_weights=w, **kw_j)
    t = tlosses.masked_loss(*(torch.from_numpy(a) for a in (out, target, mask)),
                            per_example_weights=torch.from_numpy(w), **kw_t)
    np.testing.assert_allclose(t.item(), float(j), rtol=1e-6)



def _int8_config(mode):
    cfg = tiny_flux_config(activation_checkpointing="attn")
    cfg["model"] = dict(cfg["model"], transformer_dtype="float8", int8_matmul=mode)
    return cfg


@pytest.fixture(scope="module")
def jax_int8_state():
    """The JAX trees that init_train_state builds for the tiny Flux with fp8
    block weights and int8_matmul (its frozen block weights pre-quantized
    to int8), and them as a port state_dict; both int8 modes share its
    structure."""
    cfg = _int8_config("fwd_bwd")
    pipeline = jax_model_class("flux")(cfg)
    params = random_params(pipeline, seed=5, lora_b_std=0.05)
    trainable, frozen, sd = jax_initial_state(params, jax_lora)
    return (trainable, frozen), sd


@pytest.mark.parametrize("mode", [True, "fwd_bwd"], ids=["int8", "int8_fwd_bwd"])
def test_fp8_int8_attn_loss_and_lora_grads_match(jax_int8_state, mode):
    """Tiny Flux LoRA with transformer_dtype "float8", int8_matmul `mode`
    and activation_checkpointing "attn". The JAX state crosses through
    interop.py (int8 weights, real scales) into the port's
    init_train_state, which loads it unchanged; the same noise and t.
    Tolerances: 3e-5 relative on the loss and 5e-4 abs / 5e-3 rel on each
    LoRA gradient, against a measured 5.4e-6 and 1.4e-4 abs at most (fwd_bwd;
    5e-7 and 1.8e-5 with int8 True). The difference comes from the
    activations' int8 rounding: the JAX reference runs under jit, where XLA
    multiplies by 1/127 instead of dividing by 127, so a per-row scale can
    differ by one ulp and a value at a .5 boundary round the other way;
    every other step is f32, summed in another order."""
    (trainable, frozen), sd = jax_int8_state
    cfg = _int8_config(mode)
    jpipe = one_silu(jax_model_class("flux")(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in tiny_batch(11).items()}
    ref_loss, grads = jax.jit(jax.value_and_grad(make_loss_fn(jpipe)),
                              compiler_options=JAX_FAST_COMPILE)(trainable, frozen, jbatch, KEY)
    ref_grads = jax_to_state_dict(jax.tree.map(np.asarray, grads))

    pipe = get_model_class("flux")(cfg, device="cpu")
    port = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(0),
                            lora_predicate, state_dict=sd)
    blocks = [m for m in pipe.model.modules() if isinstance(m, LoraDense) and m.lora_a is not None]
    assert len(blocks) == 40
    assert all(m.weight.dtype == torch.int8 and m.kernel_scale is not None for m in blocks)
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(v, sd[k]), k  # loaded unchanged: nothing re-quantized
    batch = tiny_batch(11)
    noise, t = jax_draws(jpipe, KEY, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    inputs, target, mask = pipe.prepare_inputs(tbatch, noise=noise, t=t)
    loss = pipe.loss_fn(pipe.forward(inputs), target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=3e-5)
    assert set(port.trainable) == set(ref_grads) and len(ref_grads) == 80
    for name, p in port.trainable.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   atol=5e-4, rtol=5e-3, err_msg=name)
