"""The "attn" activation-checkpointing policy of the port.

Under "attn" every block runs under torch.utils.checkpoint with a
context_fn that records the flash-attention forward's outputs and hands them
back in the recompute (ops/flash_attention.py record_forwards /
replay_forwards), the counterpart of the JAX package's
save_only_these_names("flash_out"). On the
tiny Flux (LoRA) and the tiny Wan (full fine-tuning), in f32 on the CPU, the
loss and every gradient must equal those of `activation_checkpointing =
true` bit for bit (the same operations on the same inputs), and the plain
flash forward must run once per attention a step under "attn", twice under
true.
"""

import numpy as np
import pytest
import torch

from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.ops import flash_attention as fa
from diffusion_pipe_tpu_torch.training.train_state import predicate_from_config
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import tiny_batch, tiny_flux_config

TINY_WAN = {"save_every_n_epochs": 1, "model": {"type": "wan", "dtype": "float32", "_tiny": True}}


def _wan_batch(rng):
    return {"latents": torch.from_numpy(rng.standard_normal((2, 16, 3, 6, 6)).astype(np.float32)),
            "text_embeddings": torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(np.float32)),
            "seq_lens": torch.tensor([7, 12], dtype=torch.int32)}


def _loss_and_grads(cfg, batch, noise, t):
    pipe = get_model_class(cfg["model"]["type"])(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    pred = predicate_from_config(cfg)
    with torch.no_grad():  # nonzero LoRA B, so the adapters get gradients through A
        for n, p in pipe.model.named_parameters():
            if n.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.05)
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(pred(n, p))
    inputs, target, mask = pipe.prepare_inputs(batch, noise=noise, t=t)
    loss = pipe.loss_fn(pipe.forward(inputs), target, mask)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in pipe.model.named_parameters() if p.requires_grad}


@pytest.mark.parametrize("model", ["flux", "wan"])
def test_attn_policy_saves_the_flash_forward(model, monkeypatch):
    rng = np.random.default_rng(0)
    if model == "flux":
        cfg = tiny_flux_config()
        batch = {k: torch.from_numpy(v) for k, v in tiny_batch(1).items()}
        attentions = 2 + 2  # one a double block, one a single block
    else:
        cfg = TINY_WAN
        batch = _wan_batch(rng)
        attentions = 2 * 2  # self- and cross-attention in each of 2 blocks
    shape = batch["latents"].shape
    noise = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = torch.tensor([0.3, 0.8])

    calls = []
    plain = fa.flash_forward_plain
    monkeypatch.setattr(fa, "flash_forward_plain", lambda *a: calls.append(1) or plain(*a))
    results = {}
    for spec in (True, "attn"):
        calls.clear()
        results[spec] = _loss_and_grads(dict(cfg, activation_checkpointing=spec),
                                        batch, noise, t)
        results[spec] += (len(calls),)
    (loss_full, grads_full, n_full), (loss_attn, grads_attn, n_attn) = (
        results[True], results["attn"])
    assert n_full == 2 * attentions and n_attn == attentions
    assert loss_attn == loss_full
    assert set(grads_attn) == set(grads_full) and len(grads_attn) > 0
    for name, g in grads_attn.items():
        torch.testing.assert_close(g, grads_full[name], rtol=0, atol=0, msg=name)
