"""Three adamw8bit steps with clipping: the port's trainer vs make_train_step.

Tiny Flux (f32, LoRA rank 4), the same initial weights (seeded numpy draws
on the JAX structure, LoRA B zero as at init, through interop.py), batch and
per-step noise/t (the JAX draws, handed to the port); the JAX trainer runs
the Flux model with SiLU applied once to the timestep embedding, as the
port does (torch_port_helpers.one_silu). The clip
threshold 0.05 sits below the grad norm (~0.3-0.6), so the clip scale is
active on every step.

eps is 1e-3, above the gradients' f32 rounding noise (~1e-10). With the
default 1e-8, Adam divides an element whose gradient is mostly rounding
noise by its own magnitude, and the int8 second moment rounds small v to
zero, so one ulp of difference between the frameworks can change an
update by orders of magnitude: the comparison would test the noise.

Tolerances:
- losses: rtol 1e-5, grad norms rtol 1e-4 -- the same f32 arithmetic
  summed in another order;
- final LoRA params: atol 5e-5 (steps of ~2e-3 each). adamw8bit rounds
  m/scale and v/scale to int8 every step; a 1e-7 difference can carry an
  element across a rounding boundary, which moves its moment by one
  quantization step (1/127 of its block's absmax) and its update by up to
  ~2e-5.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from diffusion_pipe_tpu.training.train_state import TrainState, partition_params
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.trainer import make_train_step as jax_make_step
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import (JAX_FAST_COMPILE, draw_noise_and_t, one_silu, random_params,
                                tiny_batch, tiny_flux_config)


CONFIG = tiny_flux_config(
    optimizer={"type": "adamw8bit", "lr": 2e-3, "eps": 1e-3}, gradient_clipping=0.05)
STEPS = 3


def test_three_adamw8bit_steps_match_jax():
    batch = tiny_batch(12)
    jpipe = one_silu(jax_model_class("flux")(CONFIG))
    params = random_params(jpipe, seed=6)
    jopt = jax_get_optimizer(CONFIG)
    trainable, frozen = partition_params(params, jax_lora)
    # as the JAX init_train_state builds it, with the optimizer init jitted
    jstate = TrainState(step=jnp.zeros([], jnp.int32), trainable=trainable, frozen=frozen,
                        opt_state=jax.jit(jopt.init, compiler_options=JAX_FAST_COMPILE)(
                            trainable),
                        examples=jnp.zeros([], jnp.int32))
    train_step = jax_make_step(jpipe, jopt, gradient_clipping=CONFIG["gradient_clipping"])

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def jstep(state, batch, key):
        """The step, and the noise and t that its prepare_inputs drew from
        key (one compile for both)."""
        return (*train_step(state, batch, key),
                *draw_noise_and_t(jpipe.tdist, key, batch["latents"].shape))

    pipe = get_model_class("flux")(CONFIG, device="cpu")
    state = init_train_state(pipe, get_optimizer(CONFIG), torch.Generator().manual_seed(0),
                             lora_predicate, state_dict=jax_to_state_dict(params))
    step = make_train_step(pipe, gradient_clipping=CONFIG["gradient_clipping"])

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(STEPS):
        jstate, jm, noise, t = jstep(jstate, jbatch, jax.random.PRNGKey(20 + i))
        m = step(state, tbatch, noise=torch.tensor(np.asarray(noise)),
                 t=torch.tensor(np.asarray(t)))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        assert float(jm["grad_norm"]) > CONFIG["gradient_clipping"]

    assert state.step == STEPS and state.examples == STEPS * 2
    final = jax_to_state_dict(jax.tree.map(np.asarray, nn.unbox(jstate.trainable)))
    assert set(final) == set(state.trainable)
    start = jax_to_state_dict(params)
    moved = 0.0
    for name, p in state.trainable.items():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(), atol=5e-5,
                                   rtol=0, err_msg=name)
        moved = max(moved, (final[name] - start[name]).abs().max().item())
    assert moved > 1e-3  # the steps really moved the LoRA factors


def _port_state(cfg, seed=0):
    pipe = get_model_class("flux")(cfg, device="cpu")
    state = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(seed),
                             lora_predicate)
    with torch.no_grad():  # nonzero B so every LoRA factor gets a gradient
        for name, p in state.trainable.items():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    return pipe, state


def _draws(b, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, 16, 8, 8), generator=g), torch.rand((b,), generator=g)


def test_gradient_accumulation_matches_one_big_batch():
    """Two microbatches of 2 give the same loss, grad norm and update as one
    batch of 4 with the same draws (f32: the same sums in another order)."""
    cfg = tiny_flux_config(optimizer={"type": "adamw", "lr": 1e-3})
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(14, b=4).items()}
    noise, t = _draws(4)
    results = []
    for gas in (1, 2):
        pipe, state = _port_state(cfg)
        m = make_train_step(pipe, gradient_accumulation_steps=gas)(
            state, batch, noise=noise, t=t)
        results.append((m, state))
    (m1, s1), (m2, s2) = results
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(), m1["grad_norm"].item(), rtol=1e-4)
    for name, p in s1.trainable.items():
        np.testing.assert_allclose(s2.trainable[name].detach().numpy(),
                                   p.detach().numpy(), atol=1e-6, err_msg=name)


def test_skip_invalid_grads_keeps_the_bad_parameter():
    """A NaN gradient on one factor: that factor keeps its value, its grad
    counts as zero in the norm, and the others still update."""
    pipe, state = _port_state(tiny_flux_config(optimizer={"type": "adamw8bit", "lr": 1e-3}))
    bad = "double_blocks.0.attn_to_q.lora_b"
    state.trainable[bad].register_hook(lambda g: g * float("nan"))
    before = {n: p.detach().clone() for n, p in state.trainable.items()}
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(15).items()}
    noise, t = _draws(2)
    m = make_train_step(pipe, skip_invalid_grads=True)(state, batch, noise=noise, t=t)
    assert int(m["skipped_params"]) == 1 and math.isfinite(m["grad_norm"].item())
    assert torch.equal(state.trainable[bad], before[bad])
    moved = [n for n, p in state.trainable.items() if not torch.equal(p, before[n])]
    assert len(moved) == len(before) - 1
