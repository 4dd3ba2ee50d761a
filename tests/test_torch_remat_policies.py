"""The "dots", "offload_attn", "unsloth" and "offload_dots" checkpointing
policies against activation_checkpointing = true, and adapter dropout
under checkpointing.

- "dots" keeps every product's output (product() in models/layers.py,
  the JAX package's dots_with_no_batch_dims_saveable) in the checkpoint
  call's store: its recompute runs no product, but the flash forward
  again; "offload_attn" is "attn" with the flash forwards' O and LSE in
  host memory; "unsloth" / "offload_dots" are "dots" with the outputs in
  host memory (ops/offload.py HostQueue; on the CPU, a copy in a buffer
  of its own).
- On tiny Flux (LoRA with dropout 0.25) and tiny Wan (LoKr with dropout
  0.25 and rank_dropout 0.5), f32 on the CPU, with the same dropout masks
  (KeepMasks of one seed): the loss and every gradient of each policy and
  of no checkpointing equal those of true bit for bit (the same
  operations on the same inputs, the recompute's masks redrawn from the
  recorded tokens), the flash forward runs once an attention under no
  checkpointing, "attn" and "offload_attn" and twice under the others,
  the blocks' products run once under the "dots" policies (as without
  checkpointing) and twice under true and "offload_attn", and the
  offload policies hold bytes.
- One linear under every policy, LoRA and LoKr with dropout, against the
  uncheckpointed result: bit for bit.
"""

import numpy as np
import pytest
import torch

from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import layers as tl
from diffusion_pipe_tpu_torch.ops import flash_attention as fa
from diffusion_pipe_tpu_torch.ops import offload
from diffusion_pipe_tpu_torch.training.train_state import predicate_from_config
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import tiny_batch, tiny_flux_config

POLICIES = [False, True, "dots", "offload_attn", "unsloth", "offload_dots"]
TINY_WAN = {"save_every_n_epochs": 1,
            "model": {"type": "wan", "dtype": "float32", "_tiny": True},
            "adapter": {"type": "lokr", "rank": 4, "alpha": 4, "decompose_factor": -1,
                        "rank_dropout": 0.5, "dropout": 0.25}}


def _setup(model):
    rng = np.random.default_rng(0)
    if model == "flux":
        cfg = tiny_flux_config(adapter={"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.25})
        batch = {k: torch.from_numpy(v) for k, v in tiny_batch(1).items()}
        attentions = 2 + 2
    else:
        cfg = TINY_WAN
        batch = {"latents": torch.from_numpy(rng.standard_normal((2, 16, 3, 6, 6)).astype(np.float32)),
                 "text_embeddings": torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(np.float32)),
                 "seq_lens": torch.tensor([7, 12], dtype=torch.int32)}
        attentions = 2 * 2
    noise = torch.from_numpy(rng.standard_normal(batch["latents"].shape).astype(np.float32))
    return cfg, batch, noise, torch.tensor([0.3, 0.8]), attentions


def _run(cfg, batch, noise, t):
    pipe = get_model_class(cfg["model"]["type"])(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    pred = predicate_from_config(cfg)
    with torch.no_grad():  # nonzero B / w1, so every factor gets a gradient
        gen = torch.Generator().manual_seed(1)
        for n, p in pipe.model.named_parameters():
            if n.endswith(("lora_b", "lokr_w1")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    for n, p in pipe.model.named_parameters():
        p.requires_grad_(pred(n, p))
    inputs, target, mask = pipe.prepare_inputs(batch, noise=noise, t=t)
    with tl.adapter_dropout(tl.KeepMasks(5)):
        loss = pipe.loss_fn(pipe.forward(inputs), target, mask)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in pipe.model.named_parameters() if p.requires_grad}


@pytest.mark.parametrize("model", ["flux", "wan"])
def test_policies_match_true_bit_for_bit(model, monkeypatch):
    cfg, batch, noise, t, attentions = _setup(model)
    calls = []
    plain = fa.flash_forward_plain
    monkeypatch.setattr(fa, "flash_forward_plain", lambda *a: calls.append(1) or plain(*a))
    results = {}
    for spec in POLICIES:
        calls.clear()
        tl.reset_product_count()
        offload.reset_stats()
        loss, grads = _run(dict(cfg, activation_checkpointing=spec), batch, noise, t)
        results[spec] = (loss, grads, len(calls), tl.product_count, offload.stats["bytes"])
    loss_true, grads_true, flash_true, products_true, _ = results[True]
    products_once = results[False][3]
    # the blocks' products run again in true's recompute; the embedders'
    # and the head's, outside the blocks, once
    assert products_true > products_once and flash_true == 2 * attentions
    for spec, (loss, grads, flash, products, held) in results.items():
        assert loss == loss_true, spec
        assert set(grads) == set(grads_true) and len(grads) > 0
        for name, g in grads.items():
            torch.testing.assert_close(g, grads_true[name], rtol=0, atol=0, msg=f"{spec} {name}")
        once = spec in (False, "offload_attn")
        assert flash == attentions * (1 if once else 2), spec
        keeps_products = spec in (False, "dots", "unsloth", "offload_dots")
        assert products == (products_once if keeps_products else products_true), spec
        assert (held > 0) == (spec in ("offload_attn", "unsloth", "offload_dots")), spec
    # the masks took effect: without dropout the loss differs
    no_drop = {**cfg, "adapter": {**cfg["adapter"], "dropout": 0.0, "rank_dropout": 0.0}}
    assert _run(no_drop, batch, noise, t)[0] != loss_true


@pytest.mark.parametrize("lora_type", ["lora", "lokr"])
def test_dropout_gradients_equal_with_and_without_checkpointing(lora_type):
    m = tl.LoraDense(24, 16, dtype=torch.float32, lora_rank=2, lora_alpha=2.0,
                     lora_type=lora_type, lora_dropout=0.25, lokr_rank_dropout=0.5)
    m.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        (m.lokr_w1 if lora_type == "lokr" else m.lora_b).normal_(
            generator=torch.Generator().manual_seed(1))
    x = torch.randn(3, 5, 24, generator=torch.Generator().manual_seed(2), requires_grad=True)
    results = {}
    for spec in ("",) + tl.REMAT_SPECS:
        m.zero_grad()
        x.grad = None
        with tl.adapter_dropout(tl.KeepMasks(7)):
            fn = lambda a: torch.sin(m(a)).sum()  # noqa: E731
            y = tl.remat_call(spec, fn, x) if spec else fn(x)
        y.backward()
        results[spec] = [y.detach(), x.grad.clone()] + [p.grad.clone() for p in m.parameters()
                                                         if p.grad is not None]
    for spec, got in results.items():
        assert len(got) == len(results[""])
        for a, b in zip(got, results[""]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=spec)
