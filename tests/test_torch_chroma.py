"""Tiny Chroma in the port vs the JAX package, on the same weights and draws.

The `_tiny` config (2 double + 2 single blocks, 4 heads of 32, an
Approximator of 2 layers at width 64, f32) with LoRA rank 4, and a T5
mask that pads the first example to 5 of its 8 tokens (the key mask of
every block). Weights are seeded numpy draws on the JAX parameter
structure (tests/torch_port_helpers.py), LoRA B nonzero; they cross
through interop.py. One jit gives the JAX side's output, loss and LoRA
gradients at KEY, its prepare_inputs of a masked batch at PREP_KEY, a
2-step Euler sample, and the loss of the same model with its block weights
stored in float8 (transformer_dtype); the noise and t are the JAX keys'
draws, handed to the port.

Tolerances (f32): prepare_inputs 1e-5; output 1e-4; loss 1e-5 relative
(the fp8 case too: the same fp8 bits, widened to f32 on both sides); LoRA
gradients 1e-4 abs / 1e-3 rel; the trained factors 2e-2 of the LR; the
Euler sample 1e-4 of its largest magnitude; the `_tiny` T5 hook bit for
bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, jax_draws, random_params

KEY = jax.random.PRNGKey(4)
PREP_KEY = jax.random.PRNGKey(3)
SAMPLE_KEY = jax.random.PRNGKey(7)
LR = 1e-3
# 12 LoRA linears a double block, 5 a single block, lora_a and lora_b
N_LORA = (2 * 12 + 2 * 5) * 2


def chroma_config(fp8=False, **top):
    model = {"type": "chroma", "dtype": "float32", "_tiny": True}
    if fp8:
        model["transformer_dtype"] = "float8"
    return {"model": model,
            "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
            "optimizer": {"type": "adamw", "lr": LR, "eps": 1e-2, "weight_decay": 0.01},
            "gradient_clipping": 1.0, **top}


def chroma_batch(seed, masked=False):
    rng = np.random.default_rng(seed)
    t5_mask = np.ones((2, 8), np.int32)
    t5_mask[0, 5:] = 0
    batch = {"latents": (rng.standard_normal((2, 16, 8, 8)) * 0.5).astype(np.float32),
             "t5_embed": rng.standard_normal((2, 8, 64)).astype(np.float32) * t5_mask[..., None],
             "t5_mask": t5_mask}
    if masked:
        batch["mask"] = (rng.random((2, 12, 20)) > 0.5).astype(np.float32)
    return batch


def port_pipeline(cfg, params=None):
    pipe = get_model_class("chroma")(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    if params is not None:
        pipe.model.load_state_dict(jax_to_state_dict(params))
    return pipe


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side():
    cfg, cfg8 = chroma_config(), chroma_config(fp8=True)
    pipe, pipe8 = jax_model_class("chroma")(cfg), jax_model_class("chroma")(cfg8)
    params = random_params(pipe, seed=5, lora_b_std=0.05)
    params8 = random_params(pipe8, seed=6, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    jbatch = {k: jnp.asarray(v) for k, v in chroma_batch(11).items()}
    jmasked = {k: jnp.asarray(v) for k, v in chroma_batch(12, masked=True).items()}

    def loss_fn(trainable):
        inputs, target, mask = pipe.prepare_inputs(KEY, jbatch)
        out = pipe.forward(merge_params(trainable, frozen), inputs)
        return pipe.loss_fn(out, target, mask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(trainable, params8):
        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        sample = pipe.sample(merge_params(trainable, frozen), 64, 64, SAMPLE_KEY, num_steps=2,
                             t5_embed=jbatch["t5_embed"], t5_mask=jbatch["t5_mask"])
        noise = jax.random.normal(SAMPLE_KEY, (2, 16, 8, 8), jnp.float32)
        inputs8, target8, mask8 = pipe8.prepare_inputs(KEY, jbatch)
        loss8 = pipe8.loss_fn(pipe8.forward(params8, inputs8), target8, mask8)
        return out, loss, grads, pipe.prepare_inputs(PREP_KEY, jmasked), sample, noise, loss8

    out, loss, grads, prep, sample, noise, loss8 = run(trainable, params8)
    return dict(cfg=cfg, cfg8=cfg8, pipe=pipe, params=params, params8=params8,
                out=np.asarray(out), loss=float(loss), loss8=float(loss8),
                grads=jax_to_state_dict(jax.tree.map(np.asarray, grads)),
                prep=jax.tree.map(np.asarray, prep), sample=np.asarray(sample),
                sample_noise=torch.tensor(np.asarray(noise)))


def test_prepare_inputs_matches(jax_side):
    """Flux packing and ids, guidance 0, the T5 mask, the packed loss mask."""
    ref = jax_side
    batch = chroma_batch(12, masked=True)
    j_inputs, j_target, j_mask = ref["prep"]
    noise, t = jax_draws(ref["pipe"], PREP_KEY, batch)
    pipe = port_pipeline(ref["cfg"], ref["params"])
    inputs, target, mask = pipe.prepare_inputs(_tbatch(batch), noise=noise, t=t)
    np.testing.assert_allclose(target.numpy(), j_target, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    for name, value in j_inputs.items():
        if name == "img_seq_len":
            assert inputs[name] == value
        else:
            np.testing.assert_allclose(inputs[name].numpy(), value, atol=1e-5, rtol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("remat", [False, True, "attn"])
def test_output_loss_and_lora_grads_match(jax_side, remat):
    """Output, loss and every LoRA gradient with the padded T5 mask, under
    each checkpointing setting of the port (the JAX side without)."""
    ref = jax_side
    pipe = port_pipeline(dict(ref["cfg"], activation_checkpointing=remat), ref["params"])
    batch = chroma_batch(11)
    noise, t = jax_draws(ref["pipe"], KEY, batch)
    inputs, target, mask = pipe.prepare_inputs(_tbatch(batch), noise=noise, t=t)
    for name, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(name))
    out = pipe.forward(inputs)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    lora = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    assert set(lora) == set(ref["grads"]) and len(lora) == N_LORA
    for name, p in lora.items():
        np.testing.assert_allclose(p.grad.numpy(), ref["grads"][name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_fp8_storage_loss_matches(jax_side):
    """transformer_dtype float8: the block weights cross as fp8 bits."""
    ref = jax_side
    pipe = port_pipeline(ref["cfg8"], ref["params8"])
    assert pipe.model.double_blocks[0].attn_to_q.weight.dtype == torch.float8_e4m3fn
    batch = chroma_batch(11)
    noise, t = jax_draws(ref["pipe"], KEY, batch)
    inputs, target, mask = pipe.prepare_inputs(_tbatch(batch), noise=noise, t=t)
    with torch.no_grad():
        loss = pipe.loss_fn(pipe.forward(inputs), target, mask)
    np.testing.assert_allclose(loss.item(), ref["loss8"], rtol=1e-5)


def test_train_step_matches(jax_side):
    """One train step of the port's trainer (adamw, clip 1.0): the loss, the
    global norm and every LoRA factor against adamw's first step on the
    clipped JAX gradient."""
    ref = jax_side
    cfg = ref["cfg"]
    pipe = port_pipeline(cfg)
    state = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(0),
                             lora_predicate, state_dict=jax_to_state_dict(ref["params"]))
    start = {n: p.detach().clone().numpy() for n, p in state.trainable.items()}
    batch = chroma_batch(11)
    noise, t = jax_draws(ref["pipe"], KEY, batch)
    m = make_train_step(pipe, gradient_clipping=1.0)(state, _tbatch(batch), noise=noise, t=t)
    grads = {n: ref["grads"][n].numpy() for n in state.trainable}
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    np.testing.assert_allclose(m["loss"].item(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), norm, rtol=1e-4)
    clip = min(1.0, 1.0 / (norm + 1e-6))
    assert len(state.trainable) == N_LORA
    for name, p in state.trainable.items():
        g, p0 = grads[name] * clip, start[name]
        want = p0 - LR * (g / (np.abs(g) + 1e-2) + 0.01 * p0)
        np.testing.assert_allclose(p.detach().numpy(), want, atol=2e-2 * LR, rtol=0,
                                   err_msg=name)


def test_euler_sample_matches(jax_side):
    """Two Euler steps (no shift) from the JAX sampler's noise, the T5 mask
    on."""
    ref = jax_side
    pipe = port_pipeline(ref["cfg"], ref["params"])
    batch = _tbatch(chroma_batch(11))
    got = pipe.sample(batch["t5_embed"], width=64, height=64, num_steps=2, t5_mask=batch["t5_mask"],
                      noise=ref["sample_noise"])
    scale = np.abs(ref["sample"]).max()
    np.testing.assert_allclose(got.numpy(), ref["sample"], atol=1e-4 * scale, rtol=0)


def test_tiny_t5_hook_matches():
    """min(len(caption) + 1, 8) valid rows of seeded draws, zeros after,
    and the mask: the JAX hook's arrays."""
    cfg = chroma_config()
    caps = ["a", "a longer caption"]
    (jfn,) = jax_model_class("chroma")(cfg).get_call_text_encoder_fns()
    (tfn,) = get_model_class("chroma")(cfg, device="cpu").get_call_text_encoder_fns()
    want, got = jfn(caps), tfn(caps)
    assert set(got) == set(want) == {"t5_embed", "t5_mask"}
    for k in want:
        assert got[k].dtype == torch.from_numpy(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["t5_mask"].sum(1).tolist() == [2, 8]
