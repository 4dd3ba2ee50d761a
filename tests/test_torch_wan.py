"""Tiny Wan t2v in the port vs the JAX package, on the same weights and draws.

The `_tiny` config (2 blocks, dim 64, 4 heads of 16, text 16 x 32) trained
fully (no adapter). Weights are seeded numpy draws on the JAX parameter
structure (tests/torch_port_helpers.py) and cross over through interop.py,
the scanned block stack split into blocks.{i} and the Conv3d patch kernel
transposed. The noise and t come from the JAX key, as the JAX
prepare_inputs draws them, and are handed to the port. Latents
[2, 16, 3, 6, 6] give 27 video tokens; the text is 12 tokens padded to 16,
with seq_lens 7 and 12.

f32 tolerances: 1e-5 on prepare_inputs (the same f32 arithmetic), 1e-4 on
the output and the loss, and 1e-4 abs / 1e-3 rel on every gradient (two
blocks of f32 matmuls summed in another order).

bf16 train steps (adamw lr 5e-3, eps 1e-2, clip 1.0): the two frameworks
round the bf16 forward and backward in different places, so their
gradients differ by a few bf16 ulps; eps 1e-2 keeps the Adam update
continuous in the gradient there. Each parameter element must lie within
one bf16 ulp of its magnitude per step of the JAX result, plus 0.1 * lr a
step for elements near zero, whose ulp is smaller than those gradient
differences make of the update (measured: at most 0.08 * lr).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.training.flow import sample_timesteps
from diffusion_pipe_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from diffusion_pipe_tpu.training.train_state import TrainState, merge_params, partition_params
from diffusion_pipe_tpu.training.train_state import full_ft_predicate as jax_full_ft
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.trainer import make_loss_fn as jax_make_loss_fn
from diffusion_pipe_tpu.training.trainer import make_train_step as jax_make_step
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import predicate_from_config
from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import (JAX_FAST_COMPILE, bf16_ulp, draw_noise_and_t, jax_draws,
                                jax_initial_state, random_params)

KEY = jax.random.PRNGKey(4)
LR = 5e-3


def tiny_wan_config(dtype="float32", **top):
    cfg = {
        "save_every_n_epochs": 1,
        "model": {"type": "wan", "dtype": dtype, "_tiny": True},
        "optimizer": {"type": "adamw", "lr": LR, "eps": 1e-2, "weight_decay": 0.01},
        "gradient_clipping": 1.0,
    }
    cfg.update(top)
    return cfg


def wan_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {
        "latents": (rng.standard_normal((b, 16, 3, 6, 6)) * 0.5).astype(np.float32),
        "text_embeddings": rng.standard_normal((b, 12, 32)).astype(np.float32),
        "seq_lens": np.array([7, 12][:b], np.int32),
    }


def _port(cfg, params):
    pipeline = get_model_class("wan")(cfg, device="cpu")
    pipeline.init_params(torch.Generator().manual_seed(0))
    pipeline.model.load_state_dict(jax_to_state_dict(params))
    return pipeline


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def wan_batch_with_mask(seed):
    batch = wan_batch(seed)
    batch["mask"] = (np.random.default_rng(13).random((2, 10, 14)) > 0.5).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_side():
    """JAX pipeline, weights, and its inputs, forward, loss and full-FT
    grads at KEY, for a batch with a loss mask."""
    cfg = tiny_wan_config()
    pipeline = jax_model_class("wan")(cfg)
    params = random_params(pipeline, seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in wan_batch_with_mask(11).items()}
    trainable, frozen = partition_params(params, jax_full_ft)

    def loss_fn(trainable):  # make_loss_fn's loss, with its inputs and output
        inputs, target, mask = pipeline.prepare_inputs(KEY, jbatch)
        out = pipeline.forward(merge_params(trainable, frozen), inputs)
        return pipeline.loss_fn(out, target, mask), (inputs, target, mask, out)

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(trainable):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        # the noise and t that prepare_inputs drew from KEY
        t_key, n_key = jax.random.split(KEY)
        t = sample_timesteps(t_key, 2, pipeline.tdist, image_seq_len=9)
        noise = jax.random.normal(n_key, jbatch["latents"].shape, jnp.float32)
        return loss, aux, grads, noise, t

    loss, (inputs, target, mask, out), grads, noise, t = run(trainable)
    ref = dict(inputs=jax.tree.map(np.asarray, inputs), target=np.asarray(target),
               mask=np.asarray(mask), out=np.asarray(out), loss=float(loss),
               grads=jax_to_state_dict(jax.tree.map(np.asarray, grads)),
               noise=torch.tensor(np.asarray(noise)), t=torch.tensor(np.asarray(t)))
    return cfg, pipeline, params, ref


def _port_inputs(cfg, params, ref, remat=False):
    pipe = _port(dict(cfg, activation_checkpointing=remat), params)
    return pipe, pipe.prepare_inputs(_torch_batch(wan_batch_with_mask(11)),
                                     noise=ref["noise"], t=ref["t"])


def test_prepare_inputs_matches(jax_side):
    """Including the loss mask, nearest-resized to the latent grid as [B,1,1,h,w]."""
    cfg, jpipe, params, ref = jax_side
    _, (inputs, target, mask) = _port_inputs(cfg, params, ref)
    np.testing.assert_allclose(target.numpy(), ref["target"], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), ref["mask"])
    for name in ("x", "t", "context"):
        np.testing.assert_allclose(inputs[name].numpy(), ref["inputs"][name],
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_full_ft_grads_match(jax_side, remat):
    """Output, loss and every parameter's gradient; the port runs with and
    without per-block activation checkpointing (the JAX side without)."""
    cfg, jpipe, params, ref = jax_side
    pipe, (inputs, target, mask) = _port_inputs(cfg, params, ref, remat)
    out = pipe.forward(inputs)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-4)
    named = dict(pipe.model.named_parameters())
    assert set(named) == set(ref["grads"])
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref["grads"][name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


# --- bf16 full fine-tuning steps against the JAX trainer -----------------------


def _to_numpy_f32(tree):
    return jax_to_state_dict(jax.tree.map(lambda x: np.asarray(x, np.float32), nn.unbox(tree)))


def _jax_bf16_steps(cfg, steps, stochastic_rounding):
    """`steps` steps of the JAX trainer on bf16 weights; returns the start
    and final weights (as port state_dicts), the losses and, per step, the
    noise and t that each microbatch drew, concatenated for the port."""
    gas = cfg["gradient_accumulation_steps"]
    jpipe = jax_model_class("wan")(cfg)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), random_params(jpipe, seed=7))
    tx = jax_get_optimizer(cfg)
    trainable, frozen = partition_params(params, jax_full_ft)
    jstate = TrainState(step=jnp.zeros([], jnp.int32), trainable=trainable, frozen=frozen,
                        opt_state=jax.jit(tx.init, compiler_options=JAX_FAST_COMPILE)(trainable),
                        examples=jnp.zeros([], jnp.int32))
    train_step = jax_make_step(jpipe, tx, gradient_clipping=cfg["gradient_clipping"],
                               gradient_accumulation_steps=gas,
                               stochastic_rounding=stochastic_rounding)
    batch = wan_batch(12)
    mb_shape = (batch["latents"].shape[0] // gas, *batch["latents"].shape[1:])

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def step_and_draws(state, batch, key):
        """The step, and the noise and t of each microbatch (one key each)."""
        keys = jax.random.split(key, gas) if gas > 1 else [key]
        draws = [draw_noise_and_t(jpipe.tdist, k, mb_shape) for k in keys]
        return (*train_step(state, batch, key), jnp.concatenate([d[0] for d in draws]),
                jnp.concatenate([d[1] for d in draws]))

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, draws = [], []
    for i in range(steps):
        jstate, jm, noise, t = step_and_draws(jstate, jbatch, jax.random.PRNGKey(30 + i))
        losses.append(float(jm["loss"]))
        draws.append((torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(t))))
    return _to_numpy_f32(params), _to_numpy_f32(jstate.trainable), losses, draws


def _port_bf16_steps(cfg, start, draws, stochastic_rounding):
    """The same steps in the port; also returns the dtypes of the gradients
    that its optimizer received."""
    pipe = get_model_class("wan")(cfg, device="cpu")
    state = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(0),
                             predicate_from_config(cfg),
                             state_dict={k: v.to(torch.bfloat16) for k, v in start.items()})
    step = make_train_step(pipe, gradient_clipping=cfg["gradient_clipping"],
                           gradient_accumulation_steps=cfg["gradient_accumulation_steps"],
                           stochastic_rounding=stochastic_rounding)
    received = []
    opt_step = state.optimizer.step

    def spy(grads, sr_step):
        received.append({g.dtype for g in grads})
        return opt_step(grads=grads, sr_step=sr_step)

    state.optimizer.step = spy
    batch = _torch_batch(wan_batch(12))
    losses = [step(state, batch, noise=noise, t=t)["loss"].item() for noise, t in draws]
    return state, losses, received


def _assert_within_ulps(state, final, steps):
    assert set(state.trainable) == set(final)
    for name, p in state.trainable.items():
        assert p.dtype == torch.bfloat16, name
        got, want = p.detach().float().numpy(), final[name].numpy()
        tol = steps * (bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 0.1 * LR)
        bad = np.abs(got - want) > tol
        assert not bad.any(), (name, np.abs(got - want)[bad].max(), bad.mean())


@pytest.fixture(scope="module")
def bf16_runs():
    """A bf16 full fine-tuning step with GAS 2 and stochastic_rounding, in
    the JAX trainer and in the port."""
    cfg = tiny_wan_config("bfloat16", gradient_accumulation_steps=2)
    start, final, jlosses, draws = _jax_bf16_steps(cfg, 1, True)
    return final, jlosses, _port_bf16_steps(cfg, start, draws, True)


def test_bf16_stochastic_rounding_steps_match_jax(bf16_runs):
    """Off the TPU the JAX trainer rounds to nearest, the port
    stochastically (K4's plain version on the CPU), so they may differ by
    one ulp. The port's rounding takes the other neighbour on many elements
    (rounding to nearest in both frameworks differs on about 1%)."""
    final, jlosses, (state, losses, _) = bf16_runs
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    _assert_within_ulps(state, final, 1)
    differ = total = 0
    for name, p in state.trainable.items():
        differ += int((p.detach().float().numpy() != final[name].numpy()).sum())
        total += p.numel()
    assert differ > 0.1 * total, (differ, total)


def test_bf16_gradient_accumulation_keeps_f32_grads(bf16_runs):
    """GAS 2: the averaged gradients reach the optimizer in f32 (the JAX
    scan accumulates and clips them in f32), so the adamw moments of the
    bf16 parameters turn f32, as optax's do."""
    _, _, (state, _, received) = bf16_runs
    assert received == [{torch.float32}]
    for p in state.trainable.values():
        st = state.optimizer.state[p]
        assert st["mu"].dtype == st["nu"].dtype == torch.float32


def test_lora_fp8_int8_attn_loss_and_grads_match():
    """Tiny Wan LoRA (rank 4) with transformer_dtype "float8", int8_matmul
    "fwd_bwd" and activation_checkpointing "attn": the JAX state after
    init_train_state (block weights pre-quantized to int8) crosses through
    interop.py into the port's init_train_state unchanged; the same noise
    and t. Tolerances: 2e-4 relative on the loss and 5e-4 abs / 5e-3 rel on
    each LoRA gradient, against a measured 3.4e-5 and 6.5e-5 abs at most
    (the largest gradient is 3.3e-2), the same with the JAX side run op by
    op. Every int8 linear gives the JAX function's bits on the same input
    (tests/test_torch_int8.py), and with int8_matmul off the two agree to
    5e-7; the expected source is an activation at a .5 boundary of its int8
    grid (the cross-attention inputs hold values exactly on one) that
    rounds the other way when an f32 step before it differs by one ulp,
    carried to the loss through the 27-token tiny model."""
    cfg = tiny_wan_config(activation_checkpointing="attn",
                          adapter={"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0})
    cfg["model"] = dict(cfg["model"], transformer_dtype="float8", int8_matmul="fwd_bwd")
    jpipe = jax_model_class("wan")(cfg)
    params = random_params(jpipe, seed=5, lora_b_std=0.05)
    trainable, frozen, sd = jax_initial_state(params, jax_lora)
    batch = wan_batch(11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss, grads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jpipe)),
                              compiler_options=JAX_FAST_COMPILE)(trainable, frozen, jbatch, KEY)
    ref_grads = jax_to_state_dict(jax.tree.map(np.asarray, grads))

    pipe = get_model_class("wan")(cfg, device="cpu")
    state = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(0),
                             predicate_from_config(cfg), state_dict=sd)
    assert sum(int(p.dtype == torch.int8) for p in pipe.model.parameters()) == 2 * 10
    noise, t = jax_draws(jpipe, KEY, batch)
    inputs, target, mask = pipe.prepare_inputs(_torch_batch(batch), noise=noise, t=t)
    loss = pipe.loss_fn(pipe.forward(inputs), target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=2e-4)
    assert set(state.trainable) == set(ref_grads) and len(ref_grads) == 2 * 10 * 2
    for name, p in state.trainable.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   atol=5e-4, rtol=5e-3, err_msg=name)


# --- the i2v / flf2v / i2v_v2 / ti2v variants, LoRA, from the JAX state ------

VARIANTS = ("i2v", "flf2v", "i2v_v2", "ti2v")


def variant_config(vt):
    cfg = tiny_wan_config(adapter={"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0})
    cfg["model"] = dict(cfg["model"], variant_type=vt)
    return cfg


def jax_variant_pipeline(cfg):
    """The JAX pipeline of a tiny variant. Its `_tiny` hook sets in_dim 36
    for i2v only; flf2v and i2v_v2 take the same 36 channels (latents, the
    4 mask channels and y), so their config is rebuilt with it."""
    from diffusion_pipe_tpu.models.wan_model import WanTransformer as JaxWanTransformer

    jpipe = jax_model_class("wan")(cfg)
    if jpipe.wan_config.model_type in ("flf2v", "i2v_v2"):
        jpipe.wan_config = dataclasses.replace(jpipe.wan_config, in_dim=36)
        jpipe.model = JaxWanTransformer(jpipe.wan_config)
    return jpipe


def variant_batch(vt, seed, b=2):
    rng = np.random.default_rng(seed)
    c = 8 if vt == "ti2v" else 16
    batch = {
        "latents": (rng.standard_normal((b, c, 3, 6, 6)) * 0.5).astype(np.float32),
        "text_embeddings": rng.standard_normal((b, 12, 32)).astype(np.float32),
        "seq_lens": np.array([7, 12][:b], np.int32),
    }
    if vt != "ti2v":
        batch["y"] = (rng.standard_normal((b, 16, 3, 6, 6)) * 0.5).astype(np.float32)
    if vt in ("i2v", "flf2v"):
        n = 257 * (2 if vt == "flf2v" else 1)
        batch["clip_context"] = rng.standard_normal((b, n, 1280)).astype(np.float32)
    return batch


@pytest.mark.parametrize("vt", VARIANTS)
def test_variant_lora_loss_and_grads_match(vt):
    """Loss and LoRA gradients of each variant (rank 4, f32) against the JAX
    pipeline from its init_train_state, with the JAX draws of noise and t:
    i2v / flf2v (in_dim 36, the CLIP context through img_emb and the
    k_img / v_img cross-attention over 257 / 514 image tokens), i2v_v2
    (in_dim 36, no CLIP branch) and ti2v (8 latent channels at tiny width).
    Tolerances: 1e-4 relative on the loss, 1e-4 abs / 1e-3 rel on each
    gradient (f32 through two blocks, summed in another order)."""
    cfg = variant_config(vt)
    jpipe = jax_variant_pipeline(cfg)
    params = random_params(jpipe, seed=5, lora_b_std=0.05)
    trainable, frozen, sd = jax_initial_state(params, jax_lora)
    batch = variant_batch(vt, 21)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss, grads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jpipe)),
                              compiler_options=JAX_FAST_COMPILE)(trainable, frozen, jbatch, KEY)
    ref_grads = jax_to_state_dict(jax.tree.map(np.asarray, grads))

    pipe = get_model_class("wan")(cfg, device="cpu")
    assert pipe.wan_config.in_dim == jpipe.wan_config.in_dim
    state = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(0),
                             predicate_from_config(cfg), state_dict=sd)
    noise, t = jax_draws(jpipe, KEY, batch)
    inputs, target, mask = pipe.prepare_inputs(_torch_batch(batch), noise=noise, t=t)
    loss = pipe.loss_fn(pipe.forward(inputs), target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    per_block = 12 if vt in ("i2v", "flf2v") else 10
    assert set(state.trainable) == set(ref_grads) and len(ref_grads) == 2 * per_block * 2
    for name, p in state.trainable.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


# --- weights, export, caching ----------------------------------------------------


@pytest.mark.parametrize("vt", ["t2v", "i2v"])
def test_convert_and_export_match_jax(vt):
    """convert_wan_weights of an official-layout checkpoint, export_wan_model
    and export_wan_lora_comfyui of the same weights: the JAX functions' keys
    and values, bit for bit (t2v, and i2v with the img_emb and k_img /
    v_img weights)."""
    from diffusion_pipe_tpu.models import wan as jwan
    from diffusion_pipe_tpu_torch.models import wan as pwan

    cfg = variant_config(vt)
    jpipe = jax_variant_pipeline(cfg)
    params = random_params(jpipe, seed=8, lora_b_std=0.05)
    pipe = _port(cfg, params)
    pcfg, jcfg = pipe.wan_config, jpipe.wan_config

    official = pwan.export_wan_model(pipe.model.state_dict(), pcfg)
    ref_official = jwan.export_wan_model(params, jcfg)
    assert set(official) == set(ref_official)
    for k, v in ref_official.items():
        assert torch.equal(official[k], torch.from_numpy(np.ascontiguousarray(v))), k

    ref_conv = jax_to_state_dict(jwan.convert_wan_weights(
        {f"diffusion_model.{k}": v.numpy() for k, v in official.items()}, jcfg))
    conv = pwan.convert_wan_weights(
        {f"diffusion_model.{k}": v for k, v in official.items()}, pcfg)
    frozen = {k: v for k, v in pipe.model.state_dict().items() if ".lora_" not in k}
    assert set(conv) == set(ref_conv) == set(frozen)
    for k, v in frozen.items():
        assert torch.equal(conv[k], v) and torch.equal(ref_conv[k], v), k

    trainable, _ = partition_params(params, jax_lora)
    ref_lora = jwan.export_wan_lora_comfyui(trainable, jcfg)
    lora = pwan.export_wan_lora_comfyui(
        {k: v for k, v in pipe.model.state_dict().items() if ".lora_" in k}, pcfg)
    assert set(lora) == set(ref_lora) and len(lora) == 2 * 2 * (12 if vt == "i2v" else 10)
    for k, v in ref_lora.items():
        assert torch.equal(lora[k], torch.from_numpy(v)), k


def test_save_model_writes_the_official_layout(tmp_path):
    """save_model: model.safetensors in the official layout, metadata
    format = pt, cast to save_dtype, which load_weights reads back into the
    same weights."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.wan import export_wan_model

    cfg = dict(tiny_wan_config(), save_dtype="bfloat16")
    pipe = get_model_class("wan")(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(3))
    pipe.save_model(tmp_path / "out", pipe.model)
    data = (tmp_path / "out" / "model.safetensors").read_bytes()
    assert safetensors_io.metadata(data) == {"format": "pt"}
    saved = safetensors_io.load(data)
    want = export_wan_model(pipe.model.state_dict(), pipe.wan_config)
    assert set(saved) == set(want)
    assert all(saved[k].dtype == torch.bfloat16 and torch.equal(saved[k], v.to(torch.bfloat16))
               for k, v in want.items())
    cfg["model"] = dict(cfg["model"], ckpt_path=str(tmp_path / "out"))
    loaded = get_model_class("wan")(cfg, device="cpu").load_weights()
    assert all(torch.equal(loaded[k], v.to(torch.bfloat16))
               for k, v in pipe.model.state_dict().items())


def _cache_dataset(root):
    return {"resolutions": [32], "directory": [{"path": str(root)}]}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_written_by_one_package_reads_in_the_other(tmp_path, writer, monkeypatch):
    """Tiny Wan i2v: one package's caching phase writes the latents, y, the
    CLIP context and the text embeddings; the other's reads that cache as
    it is (its VAE never runs) and its loader gives the same batches. The
    JAX pipeline's tiny VAE gets seeded weights in place of its eager init,
    and jax.jit compiles with JAX_FAST_COMPILE while the test runs."""
    from PIL import Image

    from diffusion_pipe_tpu.models.wan_vae import WanVAEConfig, WanVideoVAE

    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE))

    from diffusion_pipe_tpu.data.dataset import Dataset as JaxDataset
    from diffusion_pipe_tpu.data.loader import DatasetManager as JaxManager
    from diffusion_pipe_tpu.data.loader import PipelineDataLoader as JaxLoader
    from diffusion_pipe_tpu_torch.data.dataset import Dataset as PortDataset
    from diffusion_pipe_tpu_torch.data.loader import DatasetManager as PortManager
    from diffusion_pipe_tpu_torch.data.loader import PipelineDataLoader as PortLoader

    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(
            tmp_path / f"im{i}.png")
        (tmp_path / f"im{i}.txt").write_text(f"frame {i}")
    cfg = variant_config("i2v")
    jpipe, ppipe = jax_model_class("wan")(cfg), get_model_class("wan")(cfg, device="cpu")
    jpipe._vae = WanVideoVAE(WanVAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 4), num_res_blocks=1,
                                          temperal_downsample=(True, True)))
    shapes = jax.eval_shape(jpipe._vae.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 5, 32, 32)))
    jpipe._vae_params = jax.tree.map(
        lambda x: np.random.default_rng(x.size).standard_normal(x.shape).astype(np.float32) * 0.1,
        nn.unbox(shapes))
    sides = {"jax": (JaxDataset, JaxManager, JaxLoader, jpipe),
             "port": (PortDataset, PortManager, PortLoader, ppipe)}

    def batches(side):
        ds_cls, manager_cls, loader_cls, pipe = sides[side]
        ds = ds_cls(_cache_dataset(tmp_path), pipe, support_video=True)
        manager = manager_cls(pipe)
        manager.register(ds)
        manager.cache()
        ds.post_init(0, 1, 2, 1)
        loader = loader_cls(ds, 1)
        return [{k: np.asarray(v) for k, v in next(loader)[1].items()} for _ in range(2)]

    written = batches(writer)
    read = batches("port" if writer == "jax" else "jax")
    assert (tmp_path / "cache" / "wan").is_dir()
    assert set(written[0]) == {"latents", "y", "clip_context", "text_embeddings", "seq_lens"}
    for w, r in zip(written, read):
        assert w.keys() == r.keys()
        for k in w:
            np.testing.assert_array_equal(r[k], w[k], err_msg=k)
    if writer == "jax":
        assert getattr(ppipe, "_vae", None) is None  # the port read, did not encode


def test_uncached_text_runs_umt5_in_the_step():
    """model.cache_text_embeddings = false: host_prepare tokenizes the
    captions (the `_tiny` hook's character codes, the same ids in both
    packages) and prepare_inputs runs UMT5 without gradients. With the same
    tiny UMT5 weights in both packages, the context, x_t and t agree within
    1e-5 (f32). The port then caches no text embeddings and passes the
    captions through the loader."""
    from diffusion_pipe_tpu.models.umt5 import UMT5Config as JaxUMT5Config
    from diffusion_pipe_tpu.models.umt5 import UMT5Encoder as JaxUMT5Encoder
    from diffusion_pipe_tpu_torch.interop import tree_to_state_dict
    from diffusion_pipe_tpu_torch.models.umt5 import UMT5Config, UMT5Encoder

    cfg = tiny_wan_config()
    cfg["model"] = dict(cfg["model"], cache_text_embeddings=False)
    jpipe, ppipe = jax_model_class("wan")(cfg), get_model_class("wan")(cfg, device="cpu")
    assert ppipe.pass_captions_to_batch and ppipe.get_call_text_encoder_fns() == []
    jenc = JaxUMT5Encoder(JaxUMT5Config.tiny())
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(17)
    tparams = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32),
                           nn.unbox(shapes))
    jpipe._t5 = (jenc, jax.tree.map(jnp.asarray, tparams))
    penc = UMT5Encoder(UMT5Config.tiny())
    penc.load_state_dict(tree_to_state_dict(tparams))
    ppipe._t5 = penc

    captions = ["a cat", "two dogs on the grass at noon"]
    latents = (np.random.default_rng(3).standard_normal((2, 16, 3, 6, 6)) * 0.5).astype(np.float32)
    jb = jpipe.host_prepare({"latents": latents, "caption": np.array(captions)})
    pb = ppipe.host_prepare({"latents": torch.from_numpy(latents), "caption": captions})
    np.testing.assert_array_equal(pb["t5_input_ids"].numpy(), jb["t5_input_ids"])
    np.testing.assert_array_equal(pb["t5_mask"].numpy(), jb["t5_mask"])
    run = jax.jit(lambda b: jpipe.prepare_inputs(KEY, b)[0], compiler_options=JAX_FAST_COMPILE)
    ref = jax.tree.map(np.asarray, run({k: jnp.asarray(v) for k, v in jb.items()}))
    noise, t = jax_draws(jpipe, KEY, {"latents": latents})
    inputs, _, _ = ppipe.prepare_inputs(pb, noise=noise, t=t)
    for name in ("context", "x", "t"):
        np.testing.assert_allclose(inputs[name].numpy(), ref[name], atol=1e-5, rtol=1e-5,
                                   err_msg=name)


AUTODETECT = {  # folder name: (config.json, the shard's keys, under low_noise_model/)
    "Wan2.1-T2V-1.3B": ({"model_type": "t2v", "dim": 1536}, ["blocks.0.self_attn.q.weight"], False),
    "Wan2.1-T2V-14B": ({"model_type": "t2v", "dim": 5120}, ["blocks.0.self_attn.q.weight"], False),
    "Wan2.1-I2V-14B": ({"model_type": "i2v", "dim": 5120}, ["blocks.0.cross_attn.k_img.weight"],
                       False),
    "Wan2.2-I2V-A14B": ({"model_type": "i2v", "dim": 5120}, ["blocks.0.cross_attn.k.weight"], True),
    "Wan2.1-FLF2V-14B": ({"model_type": "flf2v", "dim": 5120}, [], False),
    "Wan2.2-TI2V-5B": ({"model_type": "ti2v", "dim": 3072}, [], False),
    "SkyReels-V2-I2V-14B": ({"model_type": "i2v", "dim": 5120},
                            ["blocks.0.cross_attn.k_img.weight"], False),
}


@pytest.mark.parametrize("name", list(AUTODETECT))
def test_autodetect_wan_variant_matches_jax(tmp_path, name):
    """autodetect_wan_variant on a checkpoint folder (config.json, a
    safetensors shard's keys, the folder's name): the JAX function's
    (variant, skyreels)."""
    import json

    from diffusion_pipe_tpu.models.wan import autodetect_wan_variant as jdetect
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.wan import autodetect_wan_variant

    config, keys, nested = AUTODETECT[name]
    d = tmp_path / name
    inner = d / "low_noise_model" if nested else d
    inner.mkdir(parents=True)
    (inner / "config.json").write_text(json.dumps(config))
    if keys:
        safetensors_io.save_file({k: torch.zeros(2) for k in keys}, inner / "model.safetensors")
    assert autodetect_wan_variant(d) == jdetect(str(d))
