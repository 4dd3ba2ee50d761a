"""LoKr adapters and adapter dropout in the port against the JAX package.

- lokr_factorization gives the JAX split for every dim in 1..4096 and the
  factors -1, 2, 4, 8 and 16;
- LoraDense with a LoKr adapter, rank-factored (w2 = w2_a @ w2_b, scaled by
  alpha / rank) and full (w2 alone, scale 1), in f32 and in bf16 compute:
  the output and the gradients of x and every factor on the JAX module's
  weights (interop.py). f32: within 1e-5 of the largest magnitude (the same
  f32 products, the Kronecker contraction in two explicit products against
  XLA's einsum); bf16: within 2e-2 of it (bf16 products rounded in
  another order, a few bf16 ulps);
- dropout with the same keep masks (GivenMasks; the JAX side's
  jax.random.bernoulli hands out the same masks in the order it draws
  them: a LoKr linear's rank mask, then the input mask): LoRA and LoKr
  outputs and gradients, f32, within 1e-5; KeepMasks keeps each element
  with the keep rate (within 4 sigma) and redraws the same mask from a
  token;
- tiny Flux and tiny Wan with `adapter.type = "lokr"`: the loss and every
  LoKr gradient against the JAX pipeline on the same weights, noise and t
  (loss rtol 1e-4; gradients 1e-4 abs / 1e-3 rel, f32 through the blocks
  summed in another order), and a train step that moves every factor,
  the zero-initialised lokr_w1 included;
- the LoKr export (Flux diffusers-lora, Wan ComfyUI) gives the JAX
  exporters' keys and bits; the Flux import reads them back;
- FluxPipeline.sample and WanPipeline.sample (shift 3), three Euler steps
  on the same tiny LoKr models with the JAX sampler's initial noise (its
  reference compiled with the gradients'): the latents within 1e-4 of
  their largest magnitude (f32 through the blocks, summed in another
  order); the sampler builds no graph and no block runs under checkpoint
  (nothing recorded), even under "attn".
The JAX Flux pipeline runs its model with SiLU applied once to the
timestep embedding, as the port does (torch_port_helpers.one_silu).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models import layers as jl
from diffusion_pipe_tpu.models.flux_convert import export_lora_diffusers as jax_flux_export
from diffusion_pipe_tpu.models.wan import export_wan_lora_comfyui as jax_wan_export
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import partition_params
from diffusion_pipe_tpu.training.trainer import make_loss_fn as jax_make_loss_fn
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import layers as tl
from diffusion_pipe_tpu_torch.models.flux_convert import export_lora_diffusers, import_lora_diffusers
from diffusion_pipe_tpu_torch.models.wan import export_wan_lora_comfyui
from diffusion_pipe_tpu_torch.ops import flash_attention as fa
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import (JAX_FAST_COMPILE, draw_noise_and_t, one_silu,
                                random_params, tiny_batch)

LOKR = {"type": "lokr", "rank": 4, "alpha": 4, "decompose_factor": -1, "rank_dropout": 0.0}
KEY = jax.random.PRNGKey(4)
SAMPLE_KEY = jax.random.PRNGKey(9)
STEPS = 3


def test_lokr_factorization_matches_jax():
    for factor in (-1, 2, 4, 8, 16):
        for dim in range(1, 4097):
            assert tl.lokr_factorization(dim, factor) == jl.lokr_factorization(dim, factor), (
                dim, factor)


def _layer_pair(rank, dtype, rng, lora_type="lokr", dropout=0.0, rank_dropout=0.0):
    """The JAX LoraDense (24 -> 16) with numpy weights, and the port's on
    the same weights."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(lora_rank=rank, lora_alpha=float(rank), lora_dropout=dropout, lora_type=lora_type,
              lokr_rank_dropout=rank_dropout)
    jm = jl.LoraDense(16, dtype=jdt, param_dtype=jnp.float32, lora_dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 24)))["params"]
    params = {"params": {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
                         for k, v in shapes.items()}}
    tm = tl.LoraDense(24, 16, dtype=tdt, param_dtype=torch.float32, lora_dtype=torch.float32, **kw)
    tm.load_state_dict(jax_to_state_dict(params))
    return jm, params, tm


def _jax_run(jm, params, x, deterministic=True):
    """y, dy/dx and the factors' gradients of sum(sin(y)), f32."""
    def f(p, x):
        y = jm.apply(p, x, deterministic=deterministic, rngs={"dropout": KEY})
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), y

    # bf16 rounded where the program rounds it: XLA's CPU compiler may
    # otherwise keep a bf16 intermediate in f32
    run = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True),
                  compiler_options={**JAX_FAST_COMPILE, "xla_allow_excess_precision": False})
    (_, y), (gp, gx) = run(params, jnp.asarray(x))
    grads = {k: np.asarray(v) for k, v in gp["params"].items() if k.startswith(("lokr", "lora"))}
    return np.asarray(y, np.float32), np.asarray(gx), grads


def _port_run(tm, x, masks=None):
    xt = torch.from_numpy(x).requires_grad_(True)
    with tl.adapter_dropout(masks) if masks is not None else torch.enable_grad():
        y = tm(xt)
    torch.sin(y.float()).sum().backward()
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters() if n.startswith(("lokr", "lora"))}
    return y.detach().float().numpy(), xt.grad.numpy(), grads


def _close(got, want, rel):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


@pytest.mark.parametrize("rank, dtype", [(2, "float32"), (2, "bfloat16"), (8, "float32"),
                                         (8, "bfloat16")],
                         ids=["factored-f32", "factored-bf16", "full-f32", "full-bf16"])
def test_lokr_dense_matches_jax(rank, dtype):
    rng = np.random.default_rng(rank)
    jm, params, tm = _layer_pair(rank, dtype, rng)
    assert tm.lokr_factored == (rank == 2) and tm.lokr_in == (4, 6) and tm.lokr_out == (4, 4)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    jy, jgx, jg = _jax_run(jm, params, x)
    ty, tgx, tg = _port_run(tm, x)
    rel = 1e-5 if dtype == "float32" else 2e-2
    _close(ty, jy, rel)
    _close(tgx, jgx, rel)
    assert set(tg) == set(jg) and len(tg) == (3 if rank == 2 else 2)
    for name in jg:
        _close(tg[name], jg[name], rel)


@pytest.mark.parametrize("lora_type", ["lora", "lokr"])
def test_dropout_with_given_masks_matches_jax(lora_type, monkeypatch):
    rng = np.random.default_rng(7)
    jm, params, tm = _layer_pair(2, "float32", rng, lora_type=lora_type, dropout=0.25,
                                 rank_dropout=0.5 if lora_type == "lokr" else 0.0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    masks = [rng.random(x.shape) > 0.25]
    if lora_type == "lokr":
        masks.insert(0, np.array([True, False]))
    queue = list(masks)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None, **kw: jnp.asarray(queue.pop(0)))
    jy, jgx, jg = _jax_run(jm, params, x, deterministic=False)
    assert not queue
    ty, tgx, tg = _port_run(tm, x, tl.GivenMasks([torch.from_numpy(m) for m in masks]))
    _close(ty, jy, 1e-5)
    _close(tgx, jgx, 1e-5)
    for name in jg:
        _close(tg[name], jg[name], 1e-5)
    # the masks took effect: without them the output differs
    y0, _, _ = _port_run(tm, x)
    assert np.abs(y0 - ty).max() > 1e-3


def test_keep_masks_rate_and_tokens():
    src = tl.KeepMasks(3)
    token = src.token()
    keep = src.mask(token, (200, 500), 0.9, "cpu")
    n = keep.numel()
    assert abs(keep.float().mean().item() - 0.9) < 4 * (0.9 * 0.1 / n) ** 0.5
    assert torch.equal(src.mask(token, (200, 500), 0.9, "cpu"), keep)
    assert not torch.equal(src.mask(src.token(), (200, 500), 0.9, "cpu"), keep)


# --- tiny Flux and tiny Wan with LoKr ------------------------------------------------


def _configs():
    flux = {"save_every_n_epochs": 1, "model": {"type": "flux", "dtype": "float32", "_tiny": True},
            "adapter": LOKR, "optimizer": {"type": "adamw8bit", "lr": 2e-3}}
    wan = {"save_every_n_epochs": 1, "model": {"type": "wan", "dtype": "float32", "_tiny": True},
           "adapter": LOKR, "optimizer": {"type": "adamw8bit", "lr": 2e-3}}
    return {"flux": flux, "wan": wan}


def _batch(family):
    if family == "flux":
        return tiny_batch(11)
    rng = np.random.default_rng(11)
    return {"latents": (rng.standard_normal((2, 16, 3, 6, 6)) * 0.5).astype(np.float32),
            "text_embeddings": rng.standard_normal((2, 12, 32)).astype(np.float32),
            "seq_lens": np.array([7, 12], np.int32)}


def _sample_case(family):
    """The sampler's inputs: the conditioning (numpy), the latent shape, and
    the JAX and port calls of FluxPipeline.sample / WanPipeline.sample
    (shift 3) for STEPS steps at 64 x 64 (Flux) or 48 x 48 px (Wan)."""
    rng = np.random.default_rng(3)
    if family == "flux":
        emb = {"t5_embed": rng.standard_normal((1, 8, 64)).astype(np.float32),
               "clip_embed": rng.standard_normal((1, 32)).astype(np.float32)}
        size, shape = 64, (1, 16, 8, 8)
    else:
        emb = {"text_embeddings": rng.standard_normal((1, 12, 32)).astype(np.float32)}
        size, shape = 48, (1, 16, 1, 6, 6)

    def jax_sample(jpipe, params):
        cond = {k: jnp.asarray(v) for k, v in emb.items()}
        if family == "flux":
            return jpipe.sample(params, cond["t5_embed"], cond["clip_embed"], width=size,
                                height=size, key=SAMPLE_KEY, num_steps=STEPS)
        return jpipe.sample(params, width=size, height=size, key=SAMPLE_KEY, num_steps=STEPS,
                            **cond)

    def port_sample(pipe, noise):
        return pipe.sample(width=size, height=size, num_steps=STEPS, noise=noise,
                           **{k: torch.from_numpy(v) for k, v in emb.items()})

    return shape, jax_sample, port_sample


@pytest.fixture(scope="module", params=["flux", "wan"])
def lokr_side(request):
    family = request.param
    cfg = _configs()[family]
    jpipe = jax_model_class(family)(cfg)
    if family == "flux":
        one_silu(jpipe)
    params = random_params(jpipe, seed=5)
    trainable, frozen = partition_params(params, jax_lora)
    batch = _batch(family)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shape, jax_sample, port_sample = _sample_case(family)

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(trainable, frozen, params):
        """The loss, its gradients and the noise and t prepare_inputs drew;
        the sample and its initial noise (one compile for all)."""
        loss, grads = jax.value_and_grad(jax_make_loss_fn(jpipe))(trainable, frozen, jbatch, KEY)
        return (loss, grads, draw_noise_and_t(jpipe.tdist, KEY, jbatch["latents"].shape),
                (jax_sample(jpipe, params), jax.random.normal(SAMPLE_KEY, shape, jnp.float32)))

    loss, grads, (noise, t), sample = run(trainable, frozen, params)
    draws = torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(t))
    sample = np.asarray(sample[0]), torch.tensor(np.asarray(sample[1])), port_sample
    return family, cfg, params, batch, float(loss), jax.tree.map(np.asarray, grads), draws, sample


def test_tiny_lokr_loss_grads_and_step_match_jax(lokr_side):
    family, cfg, params, batch, ref_loss, ref, (noise, t), _ = lokr_side
    ref_grads = jax_to_state_dict(ref)
    pipe = get_model_class(family)(cfg, device="cpu")
    state = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(0),
                             lora_predicate, state_dict=jax_to_state_dict(params))
    names = set(state.trainable)
    assert names == set(ref_grads) and all(n.rsplit(".", 1)[1].startswith("lokr_") for n in names)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    inputs, target, mask = pipe.prepare_inputs(tbatch, noise=noise, t=t)
    loss = pipe.loss_fn(pipe.forward(inputs), target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-4)
    for name, p in state.trainable.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    # from w1 = 0, as LoKr initialises it, a step moves every factor
    with torch.no_grad():
        for n, p in state.trainable.items():
            if n.endswith("lokr_w1"):
                p.zero_()
    start = {n: p.detach().clone() for n, p in state.trainable.items()}
    frozen = {n: p.detach().clone() for n, p in pipe.model.named_parameters() if not p.requires_grad}
    # w1 = 0 leaves w2's gradients zero: weight decay moves w2_a and w2_b
    make_train_step(pipe)(state, tbatch, noise=noise, t=t)
    assert all(not torch.equal(p, start[n]) for n, p in state.trainable.items())
    assert all(torch.equal(p, frozen[n]) for n, p in pipe.model.named_parameters()
               if not p.requires_grad)


def test_lokr_export_and_import_match_jax(lokr_side):
    family, cfg, params, *_ = lokr_side
    jpipe = jax_model_class(family)(cfg)
    trainable, _ = partition_params(params, jax_lora)
    pipe = get_model_class(family)(cfg, device="cpu")
    ours = jax_to_state_dict(trainable)
    if family == "flux":
        want = jax_flux_export(trainable, jpipe.flux_config)
        got = export_lora_diffusers(ours, pipe.flux_config)
    else:
        want = jax_wan_export(trainable, jpipe.wan_config)
        got = export_wan_lora_comfyui(ours, pipe.wan_config)
    assert set(got) == set(want) and len(got) == len(ours)
    assert all(".lokr_w" in k for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    if family == "flux":
        back = import_lora_diffusers({k: torch.from_numpy(v) for k, v in want.items()},
                                     pipe.flux_config)
        assert set(back) == set(ours)
        for k, v in ours.items():
            assert torch.equal(back[k], v), k


def test_euler_sample_matches_jax(lokr_side, monkeypatch):
    family, cfg, params, *_, (want, noise, port_sample) = lokr_side
    pipe = get_model_class(family)(dict(cfg, activation_checkpointing="attn"), device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    pipe.model.load_state_dict(jax_to_state_dict(params))
    recorded = []
    monkeypatch.setattr(fa, "record_forwards", lambda store: recorded.append(store))
    got = port_sample(pipe, noise)
    assert not recorded and not got.requires_grad and got.dtype == torch.float32
    assert tuple(got.shape) == tuple(noise.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(got.numpy() - noise.numpy()).max() > 0.1
