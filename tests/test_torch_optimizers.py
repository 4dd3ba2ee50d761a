"""Port optimizers and LR schedules vs the JAX package's optax chains.

Standalone parameters (a 2-D one, decayed, and a 1-D one, not decayed) and
seeded N(0, 1) gradients, three steps each of lr 1e-2. Tolerances:
- the int8 quantization of one tensor must match exactly;
- adamw: parameters within 1e-6 (the same f32 arithmetic, up to XLA's
  fused multiply-adds and bias corrections taken in f32 there, in double
  here: ~1e-7 relative);
- adamw8bit and adamw8bitkahan (its StableAdamW RMS clip): within 5e-5. Those last-bit differences can carry an element
  of m/scale or v/scale across an int8 rounding boundary, which moves its
  moment by one quantization step and its update by up to ~2e-5 a step
  (3 of 3072 elements in this test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_pipe_tpu.training import optimizers as jopt
from diffusion_pipe_tpu_torch.training import optimizers as topt
from torch_port_helpers import one_torch_thread  # noqa: F401


def test_blockwise_quantization_matches():
    x = np.random.default_rng(0).standard_normal((37, 29)).astype(np.float32)  # ragged tail
    jq, js = jopt._quantize_blockwise(jnp.asarray(x))
    tq, ts = topt.quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    back = topt.dequantize_blockwise(tq, ts, x.shape, x.size)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jopt._dequantize_blockwise(jq, js, x.shape, x.size)))


SCHEDULES = {
    "constant": {},
    "linear_warmup": {"lr_scheduler": "linear", "warmup_steps": 2, "_total_steps": 6},
    "cosine_warmup": {"lr_scheduler": "cosine", "warmup_steps": 2, "_total_steps": 6},
}


@pytest.mark.parametrize("sched", list(SCHEDULES))
def test_lr_schedules_match(sched):
    cfg = SCHEDULES[sched]
    j = jopt.build_lr_schedule(cfg, 1e-2)
    t = topt.build_lr_schedule(cfg, 1e-2)
    for step in range(10):
        jv = float(j(step)) if callable(j) else j
        tv = t(step) if callable(t) else t
        np.testing.assert_allclose(tv, jv, rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("otype", ["adamw8bit", "adamw8bitkahan", "adamw"])
def test_optimizer_steps_match(otype):
    cfg = {"optimizer": {"type": otype, "lr": 1e-2, "weight_decay": 0.1},
           "lr_scheduler": "cosine", "warmup_steps": 1, "_total_steps": 4}
    rng = np.random.default_rng(1)
    init = {"w": rng.standard_normal((64, 48)).astype(np.float32),
            "b": rng.standard_normal((48,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]

    tx = jopt.get_optimizer(cfg)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = topt.get_optimizer(cfg)(list(params.values()))
    for g in grads:
        updates, jstate = update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    atol = 1e-6 if otype == "adamw" else 5e-5
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=atol,
                                   rtol=0, err_msg=k)
        assert not np.allclose(p.detach().numpy(), init[k])
