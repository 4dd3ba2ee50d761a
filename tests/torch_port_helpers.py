"""Shared inputs for the tiny-Flux and tiny-Wan parity tests of the PyTorch port.

Weights are made with numpy from a seed on the JAX package's parameter
structure (jax.eval_shape of its init, no compile): kernels lecun-scaled
normals (cast to fp8 where the structure stores them so), biases,
modulation tables and norm scales perturbed away from 0
and 1 so the mapping of each leaf is tested, LoRA A stored uniform in
[0, 2*sqrt(6/in)) as the JAX package stores it, LoRA B zero or a small
normal.
"""

import functools
import json
import os
import re

# transformers imports TensorFlow when it finds it (seconds a process), and
# no port test uses it
os.environ.setdefault("USE_TF", "0")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

from diffusion_pipe_tpu.models.layers import prequantize_int8_tree  # noqa: E402
from diffusion_pipe_tpu.training.flow import sample_timesteps  # noqa: E402
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a port test module runs (six xdist workers
    share the host), restored afterwards for the other modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The bf16 spacing at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def tiny_flux_config(**top):
    cfg = {
        "save_every_n_epochs": 1,
        "model": {"type": "flux", "dtype": "float32", "_tiny": True},
        "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
        "optimizer": {"type": "adamw8bit", "lr": 2e-3},
    }
    cfg.update(top)
    return cfg


_SHAPES = {}


def param_shapes(pipeline):
    """jax.eval_shape of the JAX pipeline's init_params, traced once a
    process for each model (its module's repr, which holds its config) and
    model / adapter config: the test files share it."""
    # the checkpointing policy wraps blocks without renaming a parameter
    model = re.sub(r"remat=[^,)]*", "", repr(getattr(pipeline, "model", None)))
    key = (type(pipeline).__name__, model,
           json.dumps({k: pipeline.config.get(k) for k in ("model", "adapter")},
                      sort_keys=True, default=str))
    if key not in _SHAPES:
        _SHAPES[key] = nn.unbox(jax.eval_shape(pipeline.init_params, jax.random.PRNGKey(0)))
    return _SHAPES[key]


def random_params(pipeline, seed, lora_b_std=0.0):
    """A numpy parameter tree with the JAX pipeline's structure."""
    rng = np.random.default_rng(seed)
    shapes = param_shapes(pipeline)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":  # fp8 storage keeps its dtype (transformer_dtype)
            k = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
            return k.astype(leaf.dtype) if leaf.dtype.itemsize == 1 else k
        if name == "lora_a":
            bound = np.sqrt(6.0 / shape[-2])
            return rng.uniform(0.0, 2 * bound, shape).astype(np.float32)
        if name == "lora_b":
            return (rng.standard_normal(shape) * lora_b_std).astype(np.float32)
        if name.endswith("scale"):  # RMSNorm scale, Wan's norm3_scale
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)  # bias, modulation

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {
        "latents": (rng.standard_normal((b, 16, 8, 8)) * 0.5).astype(np.float32),
        "t5_embed": rng.standard_normal((b, 8, 64)).astype(np.float32),
        "clip_embed": rng.standard_normal((b, 32)).astype(np.float32),
    }


# XLA CPU compile options for the JAX references: LLVM at optimisation level
# 0 and the older fusion emitters compile a tiny model's train step about
# five times faster than the defaults; one LLVM module instead of parallel
# parts takes a fifth off that on one core (the code is the same).
JAX_FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False,
                    "xla_cpu_parallel_codegen_split_count": 1}


def draw_noise_and_t(tdist, key, shape):
    """The noise and t that the JAX prepare_inputs draws from `key` for
    latents of `shape`, as JAX arrays (traceable inside a jit)."""
    t_key, n_key = jax.random.split(key)
    b, h, w = shape[0], shape[-2], shape[-1]  # [B, C, H, W] or [B, C, F, H, W]
    t = sample_timesteps(t_key, b, tdist, image_seq_len=(h // 2) * (w // 2))
    return jax.random.normal(n_key, shape, jnp.float32), t


_draws = jax.jit(draw_noise_and_t, static_argnums=(0, 2), compiler_options=JAX_FAST_COMPILE)


def jax_draws(pipeline, key, batch):
    """The noise and t that the JAX prepare_inputs draws from `key`."""
    noise, t = _draws(pipeline.tdist, key, tuple(batch["latents"].shape))
    return torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(t))


_prequantize = jax.jit(prequantize_int8_tree, compiler_options=JAX_FAST_COMPILE)


def jax_initial_state(params, predicate):
    """The trainable and frozen trees that the JAX init_train_state builds
    from `params` (its frozen block kernels pre-quantized to int8 where the
    config asks), and the whole tree as a port state_dict, for tests that
    take no JAX optimizer step: init_train_state's eager optimizer init and
    its prequantize_int8_tree compiled with the default options take
    seconds, and give the same trees bit for bit."""
    from diffusion_pipe_tpu_torch.interop import jax_to_state_dict

    from flax import traverse_util

    trainable, frozen = partition_params(params, predicate)
    if any(k[-1] == "kernel_scale" and v is not None
           for k, v in traverse_util.flatten_dict(frozen).items()):
        frozen = _prequantize(frozen)
    sd = jax_to_state_dict(jax.tree.map(np.asarray, merge_params(trainable, frozen)))
    return trainable, frozen, sd
