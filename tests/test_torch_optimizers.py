"""Port optimizers and LR schedules vs the JAX package's optax chains.

Standalone parameters (a 2-D one, decayed, and a 1-D one, not decayed) and
seeded N(0, 1) gradients, three steps each of lr 1e-2, with f32 parameters
and with bf16 ones (bf16 gradients, as a bf16 model gives them). Tolerances:
- the int8 quantization of one tensor must match exactly;
- adamw: f32 parameters within 1e-6 (the same f32 arithmetic, up to XLA's
  fused multiply-adds: ~1e-7 relative); bf16 parameters exactly, with
  bf16 moments as optax keeps them (every operation rounds to bf16 in both
  frameworks, each Python scalar rounded to bf16 first);
- adamw8bit and adamw8bitkahan (its StableAdamW RMS clip): within 5e-5. Those last-bit differences can carry an element
  of m/scale or v/scale across an int8 rounding boundary, which moves its
  moment by one quantization step and its update by up to ~2e-5 a step
  (3 of 3072 elements in this test). With bf16 parameters such a
  difference can carry the f32 sum p + u across a bf16 rounding boundary:
  within one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_pipe_tpu.training import optimizers as jopt
from diffusion_pipe_tpu_torch.training import optimizers as topt
from torch_port_helpers import JAX_FAST_COMPILE, bf16_ulp
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


OTYPES = ["adamw8bit", "adamw8bitkahan", "adamw"]


@pytest.mark.parametrize("otype, dtype", [pytest.param(o, "float32", id=o) for o in OTYPES]
                         + [pytest.param(o, "bfloat16", id=f"{o}-bf16") for o in OTYPES])
def test_optimizer_steps_match(otype, dtype):
    cfg = {"optimizer": {"type": otype, "lr": 1e-2, "weight_decay": 0.1},
           "lr_scheduler": "cosine", "warmup_steps": 1, "_total_steps": 4}
    rng = np.random.default_rng(1)
    init = {"w": rng.standard_normal((64, 48)).astype(np.float32),
            "b": rng.standard_normal((48,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    tx = jopt.get_optimizer(cfg)
    jparams = {k: jnp.asarray(v, jdt) for k, v in init.items()}
    jstate = tx.init(jparams)
    update = jax.jit(tx.update, compiler_options=JAX_FAST_COMPILE)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(tdt)) for k, v in init.items()}
    opt = topt.get_optimizer(cfg)(list(params.values()))
    for g in grads:
        updates, jstate = update({k: jnp.asarray(v, jdt) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k]).to(tdt)
        opt.step()
    for k, p in params.items():
        assert p.dtype == tdt
        got, want = p.detach().float().numpy(), np.asarray(jparams[k], np.float32)
        if dtype == "float32":
            atol = 1e-6 if otype == "adamw" else 5e-5
        elif otype == "adamw":
            atol = 0.0
        else:  # one bf16 ulp of each element
            atol = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        bad = np.abs(got - want) > atol
        assert not bad.any(), (k, np.abs(got - want)[bad].max(), bad.mean())
        start = torch.from_numpy(init[k]).to(tdt).float().numpy()
        assert (got != start).mean() > 0.9, k  # most elements moved
    if otype == "adamw":  # optax's moments take the parameters' dtype
        jmoments = jstate[0]
        for k, p in params.items():
            assert opt.state[p]["mu"].dtype == tdt and opt.state[p]["nu"].dtype == tdt
            assert jmoments.mu[k].dtype == jdt and jmoments.nu[k].dtype == jdt
