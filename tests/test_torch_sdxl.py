"""Tiny SDXL in the port vs the JAX package, on the same weights and draws.

The `_tiny` config (UNet widths 16 / 32 / 32 with 0 / 1 / 2-deep
transformers, heads of 8, two 2-layer CLIP towers of width 16), its last
UNet stage widened to 64 (UNET), in f32.
Weights are the port's seeded init with every bias, norm scale and LoRA
B redrawn by numpy (seeded_weights), as a JAX tree, carried across by
interop.tree_to_state_dict (the port's counterpart of the JAX
flax_hf_to_torch_sd for the towers: a Dense kernel transposed, a Conv
kernel [kh, kw, in, out] to [out, in, kh, kw], `block_{k}` to `blocks.{k}`).
The noise and t are the JAX key's draws, handed to the port. One jit gives
the JAX side's inputs, output, loss and every gradient, the towers' outputs
and a DDIM sample; the train steps are held against adamw's first step on
those gradients, the exports against the JAX exporters' arrays.

Tolerances (f32): DDPM tables and weights 1e-6 relative (the same f32
arithmetic, numpy's float64 schedule on both sides); prepare_inputs 1e-5;
UNet output 1e-4; loss 1e-5 relative; gradients 1e-4 abs / 1e-3 rel (a
UNet of f32 convolutions and matmuls summed in another order); towers 1e-5;
trained parameters 2e-2 of their group's LR (a first adamw step moves
g / (|g| + eps), eps 1e-2, which a 1e-4 gradient difference moves by up
to 1e-2); the DDIM sample 1e-4 of its
largest magnitude; exports bit for bit.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models.sdxl_unet import SDXLUNet as JaxSDXLUNet
from diffusion_pipe_tpu.training import ddpm as jddpm
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import partition_params
from diffusion_pipe_tpu_torch.interop import tree_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models.sdxl_unet import SDXLUNet
from diffusion_pipe_tpu_torch.training import ddpm as tddpm
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import full_ft_predicate, lora_predicate
from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE

KEY = jax.random.PRNGKey(4)
SAMPLE_KEY = jax.random.PRNGKey(9)
CAPTIONS = ["a photo of a cat", "dog"]
LR = 1e-3
# the `_tiny` UNet (SDXL's layout: two resnets a down stage, three an up
# stage, 1- and 2-deep transformers in the last two stages) with its last
# stage widened from 32 to 64 channels, so that the two transformer stages
# have 4 and 8 heads, as SDXL's have 10 and 20. Its transformer blocks:
# 2 x 1 + 2 x 2 down, 2 mid, 3 x 2 + 3 x 1 up.
UNET = dict(block_out_channels=(16, 32, 64))
N_BLOCKS = 17


def sdxl_config(**model):
    return {
        "model": {"type": "sdxl", "dtype": "float32", "_tiny": True, "min_snr_gamma": 5.0,
                  "unet_lr": 2e-3, "text_encoder_1_lr": 5e-4, "text_encoder_2_lr": 2.5e-4,
                  **model},
        "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
        "optimizer": {"type": "adamw", "lr": LR, "eps": 1e-2, "weight_decay": 0.01},
        "gradient_clipping": 1.0,
    }


def sdxl_batch(seed):
    rng = np.random.default_rng(seed)
    return {"latents": (rng.standard_normal((2, 4, 8, 8)) * 0.5).astype(np.float32),
            "mask": (rng.random((2, 12, 20)) > 0.3).astype(np.float32)}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), nn.unbox(tree))


def _sd(tree):
    return tree_to_state_dict(_np_tree(tree))


def jax_pipeline(cfg):
    """The JAX SDXL pipeline with UNET in its UNet config, its `_tiny`
    hook's two CLIP towers built without their eager Flax init (seconds of
    op-by-op compiles a tower): the modules, and the parameters' shapes for
    init_params."""
    from transformers import CLIPTextConfig, FlaxCLIPTextModel, FlaxCLIPTextModelWithProjection

    pipe = jax_model_class("sdxl")(cfg)
    pipe.unet_config = dataclasses.replace(pipe.unet_config, **UNET)
    pipe.model = JaxSDXLUNet(pipe.unet_config)
    c = CLIPTextConfig(vocab_size=256, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                       num_attention_heads=2, max_position_embeddings=77, projection_dim=16)
    towers = []
    for cls in (FlaxCLIPTextModel, FlaxCLIPTextModelWithProjection):
        m = cls(c, _do_init=False)
        shapes = jax.eval_shape(lambda key: m.init_weights(key, (1, 77)), jax.random.PRNGKey(0))
        towers.append(types.SimpleNamespace(module=m.module, params=shapes))
    pipe._te = tuple(towers)
    return pipe


@pytest.fixture(scope="module")
def jax_side():
    """The JAX pipeline (tiny, LoRA), its weights, and from one jit: its
    inputs, output, loss and the gradient of every parameter (LoRA factors,
    UNet and towers) at KEY, the noise and t drawn from KEY, the two
    towers' context and pooled embeddings for a two-chunk prompt under
    clip_skip 1, and a 3-step DDIM sample with guidance 3 (v-prediction,
    the towers real, the UNet stand_in_denoiser)."""
    cfg = sdxl_config()
    pipe = jax_pipeline(cfg)
    params = seeded_weights(cfg, seed=5)
    batch = dict(sdxl_batch(11))
    ids = np.asarray(pipe._tokenize(CAPTIONS))
    batch.update(input_ids=ids, input_ids_2=ids)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    chunks = np.random.default_rng(3).integers(0, 256, (2, 2, 77)).astype(np.int32)
    v_pipe = jax_pipeline(sdxl_config(v_pred=True))
    v_pipe.model = types.SimpleNamespace(apply=lambda _, *args: stand_in_denoiser(jnp, *args))

    def loss_fn(p):
        inputs, target, mask = pipe.prepare_inputs(KEY, jbatch)
        pred = pipe.forward(p, inputs)
        return pipe.loss_fn(pred, target, mask), (inputs, target, mask, pred[0])

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(params):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        t_key, n_key = jax.random.split(KEY)
        t = pipe.schedule.sample_timesteps(t_key, 2)
        noise = jax.random.normal(n_key, jbatch["latents"].shape, jnp.float32)
        pipe.model_config["clip_skip"] = 1
        towers = pipe.encode_text(params["params"], chunks, chunks)
        del pipe.model_config["clip_skip"]
        sample = v_pipe.sample(params, 64, 64, SAMPLE_KEY, num_steps=3, guidance_scale=3.0,
                               caption="a cat", negative_caption="blurry")
        sample_noise = jax.random.normal(SAMPLE_KEY, (1, 4, 8, 8), jnp.float32)
        return loss, aux, grads, noise, t, towers, (sample, sample_noise)

    loss, (inputs, target, mask, pred), grads, noise, t, towers, sample = run(params)
    return dict(
        cfg=cfg, pipe=pipe, params=params, batch=batch, loss=float(loss),
        inputs=jax.tree.map(np.asarray, inputs), target=np.asarray(target),
        mask=np.asarray(mask), pred=np.asarray(pred), grads=_sd(grads),
        noise=torch.tensor(np.asarray(noise)), t=torch.tensor(np.asarray(t)),
        chunks=chunks, towers=jax.tree.map(np.asarray, towers),
        sample=jax.tree.map(np.asarray, sample))


def port_pipeline(cfg):
    """The port's SDXL pipeline with UNET in its UNet config (parameters
    allocated by init_params)."""
    pipe = get_model_class("sdxl")(cfg, device="cpu")
    pipe.unet_config = dataclasses.replace(pipe.unet_config, **UNET)
    with torch.device("meta"):
        pipe.model.unet = SDXLUNet(pipe.unet_config)
    return pipe


def stand_in_denoiser(xp, x, t, ctx, pooled, time_ids):
    """In place of the UNet in the sampler test (xp: jax.numpy or torch):
    a smooth function of the latents, the timestep, both text embeddings
    and the time ids, so guidance, the grid and the eps / x0 / v algebra
    all show; the UNet itself is held by the tests above."""
    cond = xp.tanh(ctx.mean(axis=(1, 2)) + pooled.mean(axis=1) + time_ids.mean(axis=1) / 1e3)
    return 0.6 * x + 0.2 * cond[:, None, None, None] + (t / 1000.0)[:, None, None, None] * 0.1


class StandIn(torch.nn.Module):
    def forward(self, *args):
        x, t, ctx, pooled, time_ids = args
        return stand_in_denoiser(_TorchXp, x, t.float(), ctx, pooled, time_ids)


class _TorchXp:
    tanh = staticmethod(torch.tanh)


def seeded_weights(cfg, seed):
    """Weights for both packages, as a JAX tree (_flax_tree): the port's
    seeded init (lecun-normal kernels, LoRA A uniform, embeddings normal)
    with every bias, norm scale and LoRA B drawn away from its init value
    by numpy, so the mapping of each leaf shows."""
    pipe = port_pipeline(cfg)
    pipe.init_params(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in pipe.model.state_dict().items():
        if k.endswith(("lora_b", "bias")):
            v = torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)
                                 * (0.05 if k.endswith("lora_b") else 0.02))
        elif k.endswith("weight") and v.dim() == 1:  # group / layer norm scales
            v = torch.from_numpy((1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32))
        sd[k] = v
    return _flax_tree(sd)


def _port(cfg, params):
    pipe = port_pipeline(cfg)
    pipe.init_params(torch.Generator().manual_seed(0))
    pipe.model.load_state_dict(_sd(params))
    return pipe


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --- DDPM schedule -------------------------------------------------------------


@pytest.mark.parametrize("zero_terminal_snr", [False, True])
@pytest.mark.parametrize("v_pred", [False, True])
def test_ddpm_tables_and_snr_weights(zero_terminal_snr, v_pred):
    """alphas_cumprod, add_noise, get_velocity, snr and the min-SNR-gamma /
    debiased weights (each alone and together) at every 37th timestep."""
    js = jddpm.DDPMSchedule.sdxl(v_pred, zero_terminal_snr)
    ts = tddpm.DDPMSchedule.sdxl(v_pred, zero_terminal_snr)
    assert js.alphas_cumprod == ts.alphas_cumprod
    np.testing.assert_array_equal(tddpm.scaled_linear_betas(), jddpm.scaled_linear_betas())
    steps = np.arange(0, 1000, 37, dtype=np.int32)
    if zero_terminal_snr:  # snr(999) = 0: the weights' clamps are exercised there
        steps = np.append(steps, 999).astype(np.int32)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((len(steps), 4, 2, 2)).astype(np.float32)
    eps = rng.standard_normal(x0.shape).astype(np.float32)
    weights = [(None, False), (5.0, False), (None, True), (5.0, True)]

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def ref(x0, eps, t):
        return (js.add_noise(x0, eps, t), js.get_velocity(x0, eps, t), js.snr(t),
                [jddpm.snr_loss_weight(js, t, g, d, v_pred) for g, d in weights])

    noisy, vel, snr, ws = ref(x0, eps, steps)
    t = torch.from_numpy(steps)
    tx0, teps = torch.from_numpy(x0), torch.from_numpy(eps)
    for got, want in ((ts.add_noise(tx0, teps, t), noisy), (ts.get_velocity(tx0, teps, t), vel),
                      (ts.snr(t), snr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for (g, d), want in zip(weights, ws):
        got = tddpm.snr_loss_weight(ts, t, g, d, v_pred)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_sample_timesteps():
    """Integers in [0, 1000) from the generator; a quantile gives int(q T)."""
    s = tddpm.DDPMSchedule.sdxl()
    t = s.sample_timesteps(4096, torch.Generator().manual_seed(0))
    assert t.dtype == torch.int32 and int(t.min()) >= 0 and int(t.max()) <= 999
    assert len(torch.unique(t)) > 900
    j = jddpm.DDPMSchedule.sdxl()
    for q in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(s.sample_timesteps(3, quantile=q).numpy(),
                                      np.asarray(j.sample_timesteps(None, 3, quantile=q)))


# --- the model ------------------------------------------------------------------


def test_prepare_inputs_matches(jax_side):
    """Noisy latents, integer t, add_time_ids, the eps target and the
    nearest-resized loss mask; host_prepare's ids."""
    ref = jax_side
    pipe = _port(ref["cfg"], ref["params"])
    tb = pipe.host_prepare(dict(_tbatch(sdxl_batch(11)), caption=CAPTIONS))
    np.testing.assert_array_equal(tb["input_ids"].numpy(), ref["batch"]["input_ids"])
    inputs, target, mask = pipe.prepare_inputs(tb, noise=ref["noise"], t=ref["t"])
    np.testing.assert_allclose(target.numpy(), ref["target"], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), ref["mask"])
    for name in ("sample", "timesteps", "input_ids", "input_ids_2", "add_time_ids"):
        np.testing.assert_allclose(inputs[name].numpy(), ref["inputs"][name],
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("remat", [False, True, "attn"])
def test_output_loss_and_lora_grads_match(jax_side, remat):
    """The UNet's output, the SNR-weighted loss and every LoRA gradient;
    the port with and without per-sub-block checkpointing."""
    ref = jax_side
    pipe = _port(dict(ref["cfg"], activation_checkpointing=remat), ref["params"])
    for name, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(name))
    inputs, target, mask = pipe.prepare_inputs(_tbatch(ref["batch"]), noise=ref["noise"],
                                               t=ref["t"])
    out = pipe.forward(inputs)
    np.testing.assert_allclose(out[0].detach().numpy(), ref["pred"], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    lora = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    assert len(lora) == N_BLOCKS * 10 * 2
    for name, p in lora.items():
        np.testing.assert_allclose(p.grad.numpy(), ref["grads"][name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def _adamw_first_step(p0, g, lr, wd=0.01, eps=1e-2):
    """optax adamw's first update from zero moments (bias-corrected m = g,
    v = g^2), in numpy: p - lr * (g / (|g| + eps) + wd * p), the decay on
    tensors of more than one dimension (the JAX package's mask)."""
    return p0 - lr * (g / (np.abs(g) + eps) + (wd * p0 if p0.ndim > 1 else 0))


@pytest.mark.parametrize("kind", ["lora", "full"])
def test_train_step_matches(jax_side, kind):
    """One train step (adamw, clip 1.0) of the port's trainer from the same
    weights and draws, against the JAX gradients: the loss, the global
    norm, and every trained tensor against adamw's first step on the
    clipped JAX gradient at its group's LR. Full fine-tuning trains the
    UNet and both towers with unet_lr, text_encoder_1_lr and
    text_encoder_2_lr (the LoRA run's factors take the base LR)."""
    ref = jax_side
    cfg = ref["cfg"]
    pipe = port_pipeline(cfg)
    predicate = lora_predicate if kind == "lora" else full_ft_predicate
    scales = pipe.lr_scale_map(LR) if kind == "full" else {}
    state = init_train_state(pipe, get_optimizer(cfg, lr_scales=scales),
                             torch.Generator().manual_seed(0), predicate,
                             state_dict=_sd(ref["params"]))
    start = {n: p.detach().clone().numpy() for n, p in state.trainable.items()}
    batch = pipe.host_prepare(dict(_tbatch(sdxl_batch(11)), caption=CAPTIONS))
    m = make_train_step(pipe, gradient_clipping=cfg["gradient_clipping"])(
        state, batch, noise=ref["noise"], t=ref["t"])
    grads = {n: ref["grads"][n].numpy() for n in state.trainable}
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    np.testing.assert_allclose(m["loss"].item(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), norm, rtol=1e-4)
    clip = min(1.0, cfg["gradient_clipping"] / (norm + 1e-6))
    groups = {"unet.": 2e-3, "text_encoder.": 5e-4, "text_encoder_2.": 2.5e-4}
    for name, p in state.trainable.items():
        lr = next(v for k, v in groups.items() if name.startswith(k)) if kind == "full" else LR
        g = grads[name] * clip
        want, got, zero = _adamw_first_step(start[name], g, lr), p.detach().numpy(), g == 0
        # the gradients agree to 1e-4 (abs), which moves g / (|g| + eps) by
        # up to 1e-4 / eps = 1e-2
        np.testing.assert_allclose(got[~zero], want[~zero], atol=2e-2 * lr, rtol=0,
                                   err_msg=name)
        # where the JAX gradient is 0 the step is the weight decay alone,
        # lr wd p (at least 2.5e-6 of p): held to 1e-6 of p
        np.testing.assert_allclose(got[zero], want[zero], atol=0, rtol=1e-6, err_msg=name)
    if kind == "full":  # decayed elements with no gradient: the towers' unread rows and layers
        decayed = sum(int((grads[n] == 0).sum()) for n in state.trainable if grads[n].ndim > 1)
        assert decayed > 10_000, decayed
    assert len(state.trainable) == (N_BLOCKS * 10 * 2 if kind == "lora" else len(ref["grads"]))


def test_towers_two_chunks_and_clip_skip(jax_side):
    """encode_text on a two-chunk prompt under clip_skip 1: both towers'
    hidden state at index -3 joined along the sequence (2 x 77 tokens) and
    concatenated, and bigG's projected pooled row of the first chunk."""
    ref = jax_side
    pipe = _port(dict(ref["cfg"], model=dict(ref["cfg"]["model"], clip_skip=1)), ref["params"])
    ids = torch.from_numpy(ref["chunks"])
    with torch.no_grad():
        ctx, pooled = pipe.encode_text(ids, ids)
    want_ctx, want_pooled = ref["towers"]
    assert tuple(ctx.shape) == want_ctx.shape == (2, 154, 32)
    np.testing.assert_allclose(ctx.numpy(), want_ctx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), want_pooled, atol=1e-5, rtol=1e-5)


def test_ddim_sample_matches(jax_side):
    """3 DDIM steps with guidance 3 and v-prediction from the JAX sample's
    own noise: the float64-rounded grid, the towers' encodes of the caption
    and the negative one, CFG on eps and x0 recomputed from it."""
    ref = jax_side
    pipe = _port(sdxl_config(v_pred=True), ref["params"])
    pipe.model.unet = StandIn()
    want, noise = ref["sample"]
    got = pipe.sample(64, 64, num_steps=3, guidance_scale=3.0, caption="a cat",
                      negative_caption="blurry", noise=torch.tensor(noise))
    assert tuple(got.shape) == want.shape == (1, 4, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_kohya_export_matches_jax(jax_side, tmp_path):
    """save_adapter's file: the JAX export_sdxl_lora_kohya's keys (17
    blocks x 10 linears x down, up, alpha = 510) and values, bit for bit."""
    from diffusion_pipe_tpu.models.sdxl_convert import export_sdxl_lora_kohya as jax_kohya
    from diffusion_pipe_tpu_torch import safetensors_io

    ref = jax_side
    pipe = _port(ref["cfg"], ref["params"])
    trainable = {n: p for n, p in pipe.model.named_parameters() if lora_predicate(n)}
    pipe.save_adapter(tmp_path, trainable)
    got = safetensors_io.load_file(tmp_path / "adapter_model.safetensors")
    lora_tree = {"params": {"unet": jax.tree.map(
        np.asarray, partition_params(nn.unbox(ref["params"]), jax_lora)[0])["params"]["unet"]}}
    want = jax_kohya(lora_tree, ref["pipe"].unet_config)
    assert list(got) == sorted(want, key=list(got).index) and len(got) == len(want) == N_BLOCKS * 30
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_single_file_save_and_load_round_trip(tmp_path):
    """save_model's single file against the JAX save_model's on the same
    weights (keys, values, metadata; save_dtype bf16), a VAE folder
    included; load_weights from it (checkpoint_path) gives back the UNet."""
    from safetensors.numpy import load_file as np_load
    from safetensors.numpy import save_file as np_save

    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.autoencoder_kl import (AutoencoderKL, VAEConfig,
                                                                diffusers_vae_state_dict)

    (tmp_path / "base" / "vae").mkdir(parents=True)
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.init_weights(torch.Generator().manual_seed(1))
    np_save({k: v.numpy() for k, v in diffusers_vae_state_dict(vae).items()},
            str(tmp_path / "base" / "vae" / "vae.safetensors"))
    cfg = dict(sdxl_config(), save_dtype="bfloat16")
    del cfg["adapter"]
    cfg["model"] = dict(cfg["model"], diffusers_path=str(tmp_path / "base"))
    pipe = port_pipeline(cfg)
    pipe.init_params(torch.Generator().manual_seed(6))
    jax_pipeline(cfg).save_model(str(tmp_path / "jax"),
                                                   _flax_tree(pipe.model.state_dict()))
    pipe.save_model(tmp_path / "port", pipe.model)
    raw = (tmp_path / "port" / "model.safetensors").read_bytes()
    got = safetensors_io.load(raw)
    want = np_load(str(tmp_path / "jax" / "model.safetensors"))
    assert set(got) == set(want) and safetensors_io.metadata(raw) == {"format": "pt"}
    assert any(k.startswith("first_stage_model.") for k in got)
    for k, v in want.items():
        assert got[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(got[k].float().numpy(), v.astype(np.float32), err_msg=k)

    cfg_back = dict(cfg, model=dict(cfg["model"], checkpoint_path=str(tmp_path / "port")))
    back = port_pipeline(cfg_back).load_weights()
    unet = {k: v for k, v in pipe.model.state_dict().items() if k.startswith("unet.")}
    assert set(unet) <= set(back)
    for k, v in unet.items():
        assert torch.equal(back[k], v.to(torch.bfloat16)), k


def _flax_tree(state_dict):
    """The JAX parameter tree of the port's SDXLModel weights (the inverse
    of interop.tree_to_state_dict): a conv weight [out, in, kh, kw] becomes
    the kernel [kh, kw, in, out], a linear weight the kernel [in, out], an
    embedding's `embedding`, a norm's `scale`, `blocks.{k}` `block_{k}`."""
    tree = {}
    for key, v in state_dict.items():
        path = key.replace("blocks.", "block_").split(".")
        v = v.numpy()
        name = path[-1]
        if name == "weight" and v.ndim == 4:
            name, v = "kernel", v.transpose(2, 3, 1, 0)
        elif name == "weight" and path[-2].endswith("_embedding"):
            name = "embedding"
        elif name == "weight" and v.ndim == 2:
            name, v = "kernel", v.T
        elif name == "weight":
            name = "scale"
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[name] = v
    return {"params": tree}


def test_sd_vae_keys_and_load_image_vae(tmp_path):
    """convert_diffusers_vae_keys_to_sd against the JAX function (keys and
    values, the mid attention's 1 x 1 convolutions), and
    convert_sd_vae_keys_to_diffusers back to the diffusers keys; load_image_vae from an original-SD
    single file (first_stage_model.) infers the JAX package's config and
    loads the same weights as the diffusers keys do."""
    from diffusion_pipe_tpu.models.autoencoder_kl import (
        convert_sd_vae_keys_to_diffusers as jax_sd_to_hf, infer_vae_config_from_sd as jax_infer)
    from diffusion_pipe_tpu.models.sdxl_convert import convert_diffusers_vae_keys_to_sd as jax_hf_to_sd
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.autoencoder_kl import (
        AutoencoderKL, VAEConfig, convert_sd_vae_keys_to_diffusers, diffusers_vae_state_dict,
        infer_vae_config_from_sd, load_image_vae)
    from diffusion_pipe_tpu_torch.models.sdxl_convert import convert_diffusers_vae_keys_to_sd

    cfg = VAEConfig.sdxl(block_out_channels=(8, 16), norm_num_groups=4, layers_per_block=1)
    vae = AutoencoderKL(cfg)
    vae.init_weights(torch.Generator().manual_seed(2))
    hf = diffusers_vae_state_dict(vae)
    sd = convert_diffusers_vae_keys_to_sd(hf)
    want_sd = jax_hf_to_sd({k: v.numpy() for k, v in hf.items()})
    assert set(sd) == set(want_sd) and "encoder.mid.attn_1.q.weight" in sd
    assert sd["encoder.mid.attn_1.q.weight"].shape == (16, 16, 1, 1)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    back = convert_sd_vae_keys_to_diffusers(sd)
    assert set(back) == set(hf)
    for k, v in hf.items():
        assert torch.equal(back[k], v), k
    # the JAX function agrees everywhere but on the mid attention, whose
    # "k." rename also hits "mid_block." ("mid_blocto_k."): a defect the
    # port does not copy
    want_back = jax_sd_to_hf(want_sd)
    diff = set(want_back) ^ set(back)
    assert diff and all(".mid_block.attentions.0." in k or ".mid_blocto_k.attentions.0." in k
                        for k in diff)
    for k in set(want_back) & set(back):
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want_back[k]), err_msg=k)

    got_cfg = infer_vae_config_from_sd(hf)
    want_cfg = jax_infer({k: v.numpy() for k, v in hf.items()})
    for field in ("latent_channels", "block_out_channels", "layers_per_block", "use_quant_conv",
                  "scaling_factor", "shift_factor"):
        assert getattr(got_cfg, field) == getattr(want_cfg, field), field
    safetensors_io.save_file({f"first_stage_model.{k}": v for k, v in sd.items()},
                             tmp_path / "sd_vae.safetensors")
    loaded, loaded_cfg = load_image_vae(tmp_path / "sd_vae.safetensors", norm_num_groups=4)
    assert loaded_cfg.use_quant_conv and loaded_cfg.block_out_channels == (8, 16)
    for k, v in vae.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_full_size_kohya_key_set_matches_jax():
    """The kohya key set of the full SDXL UNet at LoRA rank 16 (the
    driver-sdxl phase's config): the port's export against the JAX
    export_sdxl_lora_kohya on the same structure (factor shapes do not
    matter to the keys): 70 blocks x 10 linears x 3 = 2100 keys, the
    number chip_smoke.py's SDXL_KOHYA_KEYS holds."""
    from diffusion_pipe_tpu.models.sdxl_convert import export_sdxl_lora_kohya as jax_kohya
    from diffusion_pipe_tpu.models.sdxl_unet import SDXLConfig as JaxSDXLConfig
    from diffusion_pipe_tpu_torch.models.sdxl_convert import export_sdxl_lora_kohya
    from diffusion_pipe_tpu_torch.models.sdxl_unet import SDXLConfig

    cfg = SDXLConfig(lora_rank=16, lora_alpha=16.0)
    with torch.device("meta"):
        unet = SDXLUNet(cfg)
    names = [n for n, _ in unet.named_parameters() if n.rsplit(".", 1)[1].startswith("lora_")]
    got = export_sdxl_lora_kohya({f"unet.{n}": torch.zeros(1, 1) for n in names}, cfg)
    tree = {}
    for n in names:
        node = tree
        parts = n.replace("blocks.", "block_").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.zeros((1, 1), np.float32)
    want = jax_kohya({"params": {"unet": tree}}, JaxSDXLConfig(lora_rank=16, lora_alpha=16.0))
    assert list(got) == list(want) and len(got) == 2100
