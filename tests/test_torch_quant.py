"""Stochastic rounding (ops/quant.py): the plain version of K4 on the CPU.

The TPU kernel's bits come from the TPU's hardware PRNG and off the TPU the
JAX function rounds to nearest, so the port is held to the properties of
stochastic rounding rather than to the JAX bits:
- every output is one of the two bf16 neighbours of x (the JAX result, to
  nearest, is one of them, so the two are within one bf16 ulp);
- values exact in bf16 stay exact; NaN stays NaN, +-Inf stay;
- a fixed seed gives a fixed result, other seeds other results;
- the mean over 256 seeds of each element lies within 5 standard
  deviations of x (a Bernoulli draw between the neighbours; the bits are
  fixed by the seeds, so the check is deterministic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.ops.quant import stochastic_round as jax_stochastic_round
from diffusion_pipe_tpu_torch.ops import quant
from diffusion_pipe_tpu_torch.training.optimizers import apply_update
from torch_port_helpers import one_torch_thread  # noqa: F401


def _neighbours(x: np.ndarray):
    """The bf16 values just below and above |x| in magnitude, as f32."""
    bits = x.view(np.uint32)
    lo = bits & np.uint32(0xFFFF0000)
    hi = np.where(bits & 0xFFFF, lo + np.uint32(0x10000), lo).astype(np.uint32)
    return lo.view(np.float32), hi.view(np.float32)


def _x(n=4099, seed=0):  # a ragged size: not a multiple of 8 or 256
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(np.float32)


def test_outputs_are_bf16_neighbours_and_jax_is_within_one_ulp():
    x = _x()
    got = quant.stochastic_round_plain(torch.from_numpy(x), seed=3).float().numpy()
    lo, hi = _neighbours(x)
    assert np.all((got == lo) | (got == hi))
    assert 0.2 < np.mean(got == hi) < 0.8  # both neighbours are taken
    rtn = np.asarray(jax_stochastic_round(jnp.asarray(x), jnp.int32(3)).astype(jnp.float32))
    assert np.all(np.abs(got - rtn) <= np.abs(hi - lo))


def test_exact_values_nan_and_inf():
    exact = torch.randn(1000).to(torch.bfloat16)
    assert torch.equal(quant.stochastic_round_plain(exact.float(), 5), exact)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0,
                            np.float32(np.frombuffer(np.uint32(0x7F800001).tobytes(),
                                                     np.float32)[0])])
    out = quant.stochastic_round_plain(special, 5).float()
    assert torch.isnan(out[0]) and torch.isnan(out[5])  # a NaN whose payload is in the low bits
    assert out[1] == float("inf") and out[2] == -float("inf")
    assert out[3].item() == 0.0 and torch.signbit(out[4])


def test_seeds():
    x = torch.from_numpy(_x(seed=1))
    a, b, c = (quant.stochastic_round_plain(x, s) for s in (7, 7, 8))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # the seed wraps to 32 bits, as the kernel takes it
    assert torch.equal(quant.stochastic_round_plain(x, -1), quant.stochastic_round_plain(x, 2**32 - 1))


def test_mean_over_seeds_is_unbiased():
    x = np.random.default_rng(2).standard_normal(2048).astype(np.float32)
    lo, hi = _neighbours(x)
    xt = torch.from_numpy(x)
    n = 256
    mean = sum(quant.stochastic_round_plain(xt, s).double() for s in range(n)).numpy() / n
    p = (x.astype(np.float64) - lo) / (hi - lo).astype(np.float64)
    p = np.nan_to_num(p)  # exact elements: lo == hi
    sigma = np.abs(hi - lo) * np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(mean - x) <= 5 * sigma + 1e-12)


@pytest.mark.parametrize("udtype", [torch.bfloat16, torch.float32])
def test_sr_add_and_apply_update(udtype):
    """sr_add_ on CPU tensors is the plain version, in place; apply_update
    takes it for bf16 parameters when given a seed, and adds plainly
    otherwise or for f32 parameters."""
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.standard_normal((37, 29)).astype(np.float32)).to(torch.bfloat16)
    u = torch.from_numpy(rng.standard_normal((37, 29)).astype(np.float32) * 1e-3).to(udtype)
    want = quant.stochastic_round_plain(p.float() + u.float(), 11)
    q = p.clone()
    assert quant.sr_add_(q, u, 11) is q and torch.equal(q, want)
    q = p.clone()
    apply_update(q, u, sr_seed=11)
    assert torch.equal(q, want)
    q = p.clone()
    apply_update(q, u)
    assert torch.equal(q, (p + u).to(torch.bfloat16))
    f = p.float()
    apply_update(f, u, sr_seed=11)
    assert torch.equal(f, p.float() + u.float())


def test_kernel_wrapper_never_falls_back():
    """K4's wrapper raises on CPU tensors and on dtypes it does not take,
    before it would build anything."""
    p, u = torch.zeros(16, dtype=torch.bfloat16), torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        quant.sr_add_cuda(p, u, 0)
    with pytest.raises(TypeError):
        quant.sr_add_cuda(p.float(), u, 0)
    with pytest.raises(ValueError):
        quant.sr_add_(p.to("meta"), u.to("meta"), 0)
