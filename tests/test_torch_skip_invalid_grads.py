"""skip_invalid_grads masks the update instead of restoring a copy.

The trainer used to clone every trainable tensor before the optimizer step
and copy it back where the gradient was not finite. It now masks the update
inside optimizers.apply_update, as the JAX step masks it. `_copy_back_step`
below keeps that earlier code path as the source of the expected values:
with a NaN injected into one gradient, on tiny Flux (LoRA, adamw8bit) and on
tiny Wan (full fine-tuning in bf16, adamw with stochastic rounding), both
give the same parameters, optimizer state and skipped_params, bit for bit,
over three steps.

Also here: the "attn" checkpointing policy keeps one store of saved flash
forwards per checkpoint call, so gradient accumulation (several forwards
before one backward) gives the loss and gradients of `true`, bit for bit.
"""

import numpy as np
import pytest
import torch

from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import predicate_from_config
from diffusion_pipe_tpu_torch.training.trainer import (clip_by_global_norm, global_norm,
                                                       init_train_state, make_loss_fn,
                                                       make_train_step)
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import tiny_batch, tiny_flux_config

STEPS = 3
TINY_WAN_BF16 = {
    "save_every_n_epochs": 1,
    "model": {"type": "wan", "dtype": "bfloat16", "_tiny": True},
    "optimizer": {"type": "adamw", "lr": 5e-3, "weight_decay": 0.01,
                  "stochastic_rounding": True},
    "gradient_clipping": 1.0,
}


def _copy_back_step(pipeline, stochastic_rounding):
    """The earlier skip_invalid_grads path (GAS 1): zero the non-finite
    gradients, clone every trainable tensor, step, copy the old value back
    where the gradient was not finite."""
    loss_fn = make_loss_fn(pipeline)

    def step(state, batch, noise=None, t=None):
        params = list(state.trainable.values())
        state.optimizer.zero_grad(set_to_none=True)
        loss_fn(batch, None, noise, t).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        finite = [torch.isfinite(g).all() for g in grads]
        grads = [torch.where(ok, g, torch.zeros_like(g)) for g, ok in zip(grads, finite)]
        before = [p.detach().clone() for p in params]
        skipped = sum((~ok).int() for ok in finite)
        grads = clip_by_global_norm(grads, global_norm(grads), 1.0)
        state.optimizer.step(grads=grads, sr_step=state.step if stochastic_rounding else None)
        with torch.no_grad():
            for p, old, ok in zip(params, before, finite):
                p.copy_(torch.where(ok, p, old))
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return {"skipped_params": skipped}

    return step


def _flux_case():
    cfg = tiny_flux_config(optimizer={"type": "adamw8bit", "lr": 1e-3})
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(15).items()}
    return cfg, batch, "double_blocks.0.attn_to_q.lora_b", False


def _wan_case():
    rng = np.random.default_rng(3)
    batch = {"latents": torch.from_numpy(rng.standard_normal((2, 16, 3, 6, 6)).astype(np.float32)),
             "text_embeddings": torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(np.float32)),
             "seq_lens": torch.tensor([7, 12], dtype=torch.int32)}
    return TINY_WAN_BF16, batch, "blocks.1.ffn_in.weight", True


def _run(case, masked: bool):
    cfg, batch, bad, sr = case()
    pipe = get_model_class(cfg["model"]["type"])(cfg, device="cpu")
    state = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(0),
                             predicate_from_config(cfg))
    with torch.no_grad():  # nonzero LoRA B, so every LoRA factor gets a gradient
        for name, p in state.trainable.items():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    state.trainable[bad].register_hook(lambda g: g * float("nan"))
    if masked:
        step = make_train_step(pipe, gradient_clipping=1.0, skip_invalid_grads=True,
                               stochastic_rounding=sr)
    else:
        step = _copy_back_step(pipe, sr)
    g = torch.Generator().manual_seed(5)
    skipped = []
    for _ in range(STEPS):
        noise = torch.randn(batch["latents"].shape, generator=g)
        t = torch.rand((batch["latents"].shape[0],), generator=g)
        skipped.append(int(step(state, batch, noise=noise, t=t)["skipped_params"]))
    return state, skipped, bad


@pytest.mark.parametrize("case", [_flux_case, _wan_case], ids=["flux-lora-adamw8bit",
                                                                "wan-fullft-bf16-sr"])
def test_masked_update_equals_the_copy_back(case):
    new, skipped_new, bad = _run(case, masked=True)
    old, skipped_old, _ = _run(case, masked=False)
    assert skipped_new == skipped_old == [1] * STEPS
    names = list(new.trainable)
    assert names == list(old.trainable)
    moved = 0
    for name in names:
        a, b = new.trainable[name], old.trainable[name]
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8) if a.dtype.itemsize == 1 else a, b), name
        moved += int(name != bad)
    assert moved == len(names) - 1
    for p_new, p_old in zip(new.trainable.values(), old.trainable.values()):
        st_new, st_old = new.optimizer.state[p_new], old.optimizer.state[p_old]
        assert st_new.keys() == st_old.keys()
        for key, val in st_new.items():
            if torch.is_tensor(val):
                assert val.dtype == st_old[key].dtype
                assert torch.equal(val, st_old[key]), key
            else:
                assert val == st_old[key], key


def test_attn_store_per_checkpoint_call_under_gas():
    """GAS 2 under "attn": two forwards before one backward each replay
    their own saved flash forwards (loss and grads equal `true`'s)."""
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(16, b=4).items()}
    g = torch.Generator().manual_seed(7)
    noise, t = torch.randn((4, 16, 8, 8), generator=g), torch.rand((4,), generator=g)
    results = {}
    for spec in (True, "attn"):
        cfg = tiny_flux_config(optimizer={"type": "adamw", "lr": 1e-3},
                               activation_checkpointing=spec)
        pipe = get_model_class("flux")(cfg, device="cpu")
        state = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(0),
                                 predicate_from_config(cfg))
        with torch.no_grad():
            for name, p in state.trainable.items():
                if name.endswith("lora_b"):
                    p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
        m = make_train_step(pipe, gradient_accumulation_steps=2)(state, batch, noise=noise, t=t)
        results[spec] = (m["loss"].item(), m["grad_norm"].item(),
                         {n: p.detach().clone() for n, p in state.trainable.items()})
    (loss_t, norm_t, params_t), (loss_a, norm_a, params_a) = results[True], results["attn"]
    assert loss_a == loss_t and norm_a == norm_t
    for name, p in params_a.items():
        assert torch.equal(p, params_t[name]), name
