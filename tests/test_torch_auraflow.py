"""Tiny AuraFlow in the port vs the JAX package.

The `_tiny` config (2 joint + 2 single blocks, 4 heads of 8, text 24 wide,
an 8 x 8 position table, f32) with LoRA rank 4, LoRA B nonzero. Seeded numpy
weights on the JAX parameter structure (tests/torch_port_helpers.py) cross
through interop.auraflow_state_dict, which reorders the patch projection
into diffusers' (channel, row, column) patch order, the port's (the JAX
module flattens a patch as (row, column, channel)). One jit gives the JAX
prepare_inputs' noise and t, the output, the loss (with a loss mask) and
every LoRA gradient. Tolerances (f32): output 1e-4, loss 1e-5 relative,
LoRA gradients 1e-4 abs / 1e-3 rel (f32 sums in another order).

Exact: pe_selection_indices against the JAX function; the port's
convert_diffusers_auraflow against the JAX one on the diffusers-keyed
state dict that the JAX test suite's inverse writes
(torch_port_helpers.auraflow_fake_sd); the port's KeyMap, which the JAX
pipeline lacks, against that inverse both ways; the adapter export and its
re-import; load_weights from a `model.`-prefixed file.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models.auraflow import convert_diffusers_auraflow as jax_convert
from diffusion_pipe_tpu.models.auraflow import pe_selection_indices as jax_pe
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import (auraflow_config, auraflow_state_dict,
                                              jax_to_state_dict)
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models.auraflow import (convert_diffusers_auraflow,
                                                      pe_selection_indices)
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, auraflow_fake_sd, jax_draws, random_params

KEY = jax.random.PRNGKey(6)


def af_cfg(**model):
    return {"save_every_n_epochs": 1,
            "model": {"type": "auraflow", "dtype": "float32", "_tiny": True, **model},
            "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
            "optimizer": {"type": "adamw", "lr": 1e-3}}


def af_batch(seed):
    rng = np.random.default_rng(seed)
    return {"latents": (rng.standard_normal((2, 4, 8, 12)) * 0.5).astype(np.float32),
            "prompt_embeds": rng.standard_normal((2, 8, 24)).astype(np.float32),
            "mask": (rng.random((2, 12, 20)) > 0.5).astype(np.float32)}


@pytest.fixture(scope="module")
def ref():
    cfg = af_cfg()
    jpipe = jax_model_class("auraflow")(cfg)
    params = random_params(jpipe, seed=7, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    batch = af_batch(21)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(tr):
        mi, target, mask = jpipe.prepare_inputs(KEY, jbatch)
        out = jpipe.model.apply(merge_params(tr, frozen), **mi)
        return jpipe.loss_fn(out, target, mask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(tr):
        return jax.value_and_grad(loss_fn, has_aux=True)(tr)

    (loss, out), grads = run(trainable)
    return dict(jpipe=jpipe, params=jax.tree.map(np.asarray, params), batch=batch,
                loss=float(loss), out=np.asarray(out),
                grads=jax_to_state_dict(jax.tree.map(np.asarray, grads)))


def port_pipeline(ref, **over):
    pipe = get_model_class("auraflow")(af_cfg(), device="cpu")
    assert pipe.af_config == auraflow_config(ref["jpipe"].af_config)
    if over:
        import dataclasses

        from diffusion_pipe_tpu_torch.models.auraflow import AuraFlowTransformer

        pipe.af_config = dataclasses.replace(pipe.af_config, **over)
        pipe.model = AuraFlowTransformer(pipe.af_config)
    pipe.model.to_empty(device="cpu")
    pipe.model.load_state_dict(auraflow_state_dict(ref["params"], pipe.af_config))
    return pipe


@pytest.mark.parametrize("remat", ["", "attn"])
def test_forward_and_lora_grads_match(ref, remat):
    """The whole module: output, loss (masked) and every LoRA gradient."""
    pipe = port_pipeline(ref, remat=remat)
    noise, t = jax_draws(ref["jpipe"], KEY, ref["batch"])
    inputs, target, mask = pipe.prepare_inputs(
        {k: torch.from_numpy(v) for k, v in ref["batch"].items()}, noise=noise, t=t)
    assert mask.shape == (2, 1, 8, 12)
    for name, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(name))
    out = pipe.forward(inputs)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    lora = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    assert set(lora) == set(ref["grads"]) and len(lora) == (2 * 16 + 2 * 8) * 2
    for name, p in lora.items():
        np.testing.assert_allclose(p.grad.numpy(), ref["grads"][name].numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("pos_max, hp, wp", [(64, 4, 4), (64, 4, 6), (9216, 64, 64),
                                             (9216, 48, 80), (9216, 3, 5)])
def test_pe_selection_matches_jax(pos_max, hp, wp):
    np.testing.assert_array_equal(pe_selection_indices(pos_max, hp, wp), jax_pe(pos_max, hp, wp))


def _sd(ref):
    return auraflow_fake_sd(ref["params"], ref["jpipe"].af_config)


def test_converter_matches_jax(ref):
    """convert_diffusers_auraflow of the diffusers-keyed state dict is the
    JAX converter's tree, bit for bit (the patch projection as stored: both
    read a checkpoint's columns as they lie)."""
    sd = _sd(ref)
    pipe = get_model_class("auraflow")(af_cfg(), device="cpu")
    got = convert_diffusers_auraflow({k: torch.from_numpy(np.ascontiguousarray(v))
                                      for k, v in sd.items()}, pipe.af_config)
    want = jax_to_state_dict(jax_convert(sd, ref["jpipe"].af_config))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert set(got) == {k for k in pipe.model.state_dict() if "lora" not in k}


def test_keymap_is_the_inverse_of_the_converter(ref):
    """The port's KeyMap writes exactly the diffusers names and tensors that
    the JAX suite's inverse writes, and reads them back."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _sd(ref).items()}
    pipe = get_model_class("auraflow")(af_cfg(), device="cpu")
    weights = jax_to_state_dict(ref["params"])
    frozen = {k: v for k, v in weights.items() if "lora" not in k}
    out = tkm.keymap_from_state_dict(frozen, pipe.keymap(), pipe.af_config)
    assert set(out) == set(sd)
    for k, v in sd.items():
        assert torch.equal(out[k], v), k
    back = tkm.keymap_to_state_dict(out, pipe.keymap(), pipe.af_config)
    assert set(back) == set(frozen) and all(torch.equal(back[k], frozen[k]) for k in back)


def test_load_weights_and_adapter_round_trip(ref, tmp_path):
    """A `model.`-prefixed file of the original checkpoints loads through
    load_weights; the adapter goes out under `diffusion_model.` in
    diffusers' names (48 pairs) and comes back bit for bit."""
    sd = {"model." + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _sd(ref).items()}
    safetensors_io.save_file(sd, str(tmp_path / "auraflow.safetensors"))
    pipe = get_model_class("auraflow")(
        af_cfg(transformer_path=str(tmp_path / "auraflow.safetensors")), device="cpu")
    loaded = pipe.load_weights()
    weights = jax_to_state_dict(ref["params"])
    assert all(torch.equal(loaded[k], weights[k]) for k in loaded)
    factors = {k: v for k, v in weights.items() if lora_predicate(k)}
    pipe.save_adapter(tmp_path / "adapter", factors)
    saved = safetensors_io.load_file(tmp_path / "adapter" / "adapter_model.safetensors")
    assert sum(k.endswith(".lora_A.weight") for k in saved) == 48
    assert "diffusion_model.joint_transformer_blocks.1.ff_context.out_projection.lora_B.weight" \
        in saved
    back = pipe.load_adapter(tmp_path / "adapter")
    assert set(back) == set(factors) and all(torch.equal(back[k], factors[k]) for k in back)
