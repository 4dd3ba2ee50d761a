"""Tiny SD3 in the port vs the JAX package, on the same weights and draws.

The `_tiny` config (one scanned joint block and the context_pre_only final
block, 4 heads of 16, f32) with qk_norm on (set on both sides: neither
pipeline reads it) and LoRA rank 4. Weights are seeded numpy draws on the
JAX parameter structure (tests/torch_port_helpers.py), LoRA B nonzero;
they cross through interop.py. One jit gives the JAX side's output, loss
and LoRA gradients at KEY, its prepare_inputs of a masked batch at
PREP_KEY and a 2-step Euler sample; the noise and t are the JAX keys'
draws, handed to the port. The reference model is the JAX submodules
composed with SiLU applied once to temb (torch_port_helpers.sd3_one_silu,
the JAX pipeline's forward through one_silu), as diffusers computes SD3;
the JAX SD3Transformer applies it twice, and its output differs (checked).

Tolerances (f32): prepare_inputs 1e-5; output 1e-4; loss 1e-5 relative;
LoRA gradients 1e-4 abs / 1e-3 rel (f32 matmuls summed in another order);
the trained factors 2e-2 of the LR (a first adamw step moves g / (|g| +
eps), eps 1e-2, which a 1e-4 gradient difference moves by up to 1e-2);
the Euler sample 1e-4 of its largest magnitude; the `_tiny` text hooks
bit for bit; the CLIP function's tower against transformers' torch
CLIPTextModelWithProjection 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models.sd3_model import SD3Transformer as JaxSD3
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models.sd3_model import SD3Transformer
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, jax_draws, one_silu, random_params

KEY = jax.random.PRNGKey(4)
PREP_KEY = jax.random.PRNGKey(3)
SAMPLE_KEY = jax.random.PRNGKey(7)
LR = 1e-3
EMBEDS = ("prompt_embed", "prompt_2_embed", "pooled_prompt_embed", "pooled_prompt_2_embed",
          "t5_prompt_embed")
# one scanned block (14 linears) and the final block (11), lora_a and lora_b
N_LORA = (14 + 11) * 2


def sd3_config(**top):
    return {"model": {"type": "sd3", "dtype": "float32", "_tiny": True},
            "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
            "optimizer": {"type": "adamw", "lr": LR, "eps": 1e-2, "weight_decay": 0.01},
            "gradient_clipping": 1.0, **top}


def sd3_batch(seed, masked=False):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    batch = {"latents": r(2, 16, 8, 8) * 0.5, "prompt_embed": r(2, 8, 24),
             "prompt_2_embed": r(2, 8, 24), "pooled_prompt_embed": r(2, 16),
             "pooled_prompt_2_embed": r(2, 16), "t5_prompt_embed": r(2, 8, 64)}
    if masked:
        batch["mask"] = (rng.random((2, 12, 20)) > 0.5).astype(np.float32)
    return batch


def jax_pipeline(cfg):
    pipe = jax_model_class("sd3")(cfg)
    pipe.sd3_config = dataclasses.replace(pipe.sd3_config, qk_norm=True)
    pipe.model = JaxSD3(pipe.sd3_config)
    return one_silu(pipe)


def port_pipeline(cfg, params=None):
    pipe = get_model_class("sd3")(cfg, device="cpu")
    pipe.sd3_config = dataclasses.replace(pipe.sd3_config, qk_norm=True)
    with torch.device("meta"):
        pipe.model = SD3Transformer(pipe.sd3_config)
    pipe.init_params(torch.Generator().manual_seed(0))
    if params is not None:
        pipe.model.load_state_dict(jax_to_state_dict(params))
    return pipe


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side():
    cfg = sd3_config()
    pipe = jax_pipeline(cfg)
    params = random_params(pipe, seed=5, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    jbatch = {k: jnp.asarray(v) for k, v in sd3_batch(11).items()}
    jmasked = {k: jnp.asarray(v) for k, v in sd3_batch(12, masked=True).items()}

    def loss_fn(trainable):
        inputs, target, mask = pipe.prepare_inputs(KEY, jbatch)
        out = pipe.forward(merge_params(trainable, frozen), inputs)
        return pipe.loss_fn(out, target, mask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(trainable):
        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        sample = pipe.sample(merge_params(trainable, frozen), 64, 64, SAMPLE_KEY, num_steps=2,
                             **{k: jbatch[k] for k in EMBEDS})
        noise = jax.random.normal(SAMPLE_KEY, (2, 16, 8, 8), jnp.float32)
        whole = pipe.model.apply(params, **pipe.prepare_inputs(KEY, jbatch)[0])
        return out, loss, grads, pipe.prepare_inputs(PREP_KEY, jmasked), sample, noise, whole

    out, loss, grads, prep, sample, noise, whole = run(trainable)
    return dict(cfg=cfg, pipe=pipe, params=params, out=np.asarray(out), loss=float(loss),
                whole=np.asarray(whole),
                grads=jax_to_state_dict(jax.tree.map(np.asarray, grads)),
                prep=jax.tree.map(np.asarray, prep), sample=np.asarray(sample),
                sample_noise=torch.tensor(np.asarray(noise)))


def test_jax_module_applies_silu_twice(jax_side):
    """The reference here is the JAX submodules composed with one SiLU on
    temb (torch_port_helpers.sd3_one_silu); the JAX SD3Transformer applies
    it twice, and its output differs from the composition by far more than
    the port's 1e-4 tolerance."""
    assert np.abs(jax_side["whole"] - jax_side["out"]).max() > 1e-2
    assert not np.allclose(jax_side["whole"], jax_side["out"], atol=1e-3, rtol=1e-3)


def test_prepare_inputs_matches(jax_side):
    """The prompt assembly (CLIP ‖ CLIP-G zero-padded to the T5 width,
    before T5), the pooled concat, the nearest mask resize, t x 1000."""
    ref = jax_side
    batch = sd3_batch(12, masked=True)
    j_inputs, j_target, j_mask = ref["prep"]
    noise, t = jax_draws(ref["pipe"], PREP_KEY, batch)
    pipe = port_pipeline(ref["cfg"], ref["params"])
    inputs, target, mask = pipe.prepare_inputs(_tbatch(batch), noise=noise, t=t)
    np.testing.assert_allclose(target.numpy(), j_target, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    for name, value in j_inputs.items():
        np.testing.assert_allclose(inputs[name].numpy(), value, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("remat", [False, True, "attn"])
def test_output_loss_and_lora_grads_match(jax_side, remat):
    """Output, loss and every LoRA gradient under each checkpointing
    setting of the port (the JAX side without)."""
    ref = jax_side
    pipe = port_pipeline(dict(ref["cfg"], activation_checkpointing=remat), ref["params"])
    batch = sd3_batch(11)
    noise, t = jax_draws(ref["pipe"], KEY, batch)
    inputs, target, mask = pipe.prepare_inputs(_tbatch(batch), noise=noise, t=t)
    for name, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(name))
    out = pipe.forward(inputs)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    lora = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    assert set(lora) == set(ref["grads"]) and len(lora) == N_LORA
    for name, p in lora.items():
        np.testing.assert_allclose(p.grad.numpy(), ref["grads"][name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_train_step_matches(jax_side):
    """One train step of the port's trainer (adamw, clip 1.0) from the same
    weights and draws: the loss, the global norm and every LoRA factor
    against adamw's first step on the clipped JAX gradient."""
    ref = jax_side
    cfg = ref["cfg"]
    pipe = port_pipeline(cfg)
    state = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(0),
                             lora_predicate, state_dict=jax_to_state_dict(ref["params"]))
    start = {n: p.detach().clone().numpy() for n, p in state.trainable.items()}
    batch = sd3_batch(11)
    noise, t = jax_draws(ref["pipe"], KEY, batch)
    m = make_train_step(pipe, gradient_clipping=1.0)(state, _tbatch(batch), noise=noise, t=t)
    grads = {n: ref["grads"][n].numpy() for n in state.trainable}
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    np.testing.assert_allclose(m["loss"].item(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), norm, rtol=1e-4)
    clip = min(1.0, 1.0 / (norm + 1e-6))
    assert len(state.trainable) == N_LORA
    for name, p in state.trainable.items():
        g, p0 = grads[name] * clip, start[name]
        want = p0 - LR * (g / (np.abs(g) + 1e-2) + 0.01 * p0)
        np.testing.assert_allclose(p.detach().numpy(), want, atol=2e-2 * LR, rtol=0,
                                   err_msg=name)


def test_euler_sample_matches(jax_side):
    """Two Euler steps at shift 3.0 from the JAX sampler's noise."""
    ref = jax_side
    pipe = port_pipeline(ref["cfg"], ref["params"])
    embeds = {k: torch.from_numpy(sd3_batch(11)[k]) for k in EMBEDS}
    got = pipe.sample(width=64, height=64, num_steps=2, noise=ref["sample_noise"], **embeds)
    scale = np.abs(ref["sample"]).max()
    np.testing.assert_allclose(got.numpy(), ref["sample"], atol=1e-4 * scale, rtol=0)


def test_tiny_text_hooks_and_vae_config_match():
    """The `_tiny` CLIP-L / CLIG-G / T5 functions give the JAX hook's
    arrays; VAEConfig.sd3 the JAX pipeline's VAE numbers."""
    from diffusion_pipe_tpu.models.autoencoder_kl import VAEConfig as JaxVAEConfig
    from diffusion_pipe_tpu_torch.models.autoencoder_kl import VAEConfig

    cfg = sd3_config()
    caps = ["a cat", "two dogs on a mat"]
    for jfn, tfn in zip(jax_model_class("sd3")(cfg).get_call_text_encoder_fns(),
                        get_model_class("sd3")(cfg, device="cpu").get_call_text_encoder_fns()):
        want, got = jfn(caps), tfn(caps)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    want = JaxVAEConfig(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609,
                        use_quant_conv=False)
    got = VAEConfig.sd3()
    for field in ("latent_channels", "scaling_factor", "shift_factor", "use_quant_conv",
                  "block_out_channels", "layers_per_block", "norm_num_groups"):
        assert getattr(got, field) == getattr(want, field), field


def test_clip_function_gives_penultimate_and_projected_pooled(tmp_path, monkeypatch):
    """The real CLIP function: the port's tower loaded from a diffusers
    text_encoder folder gives transformers' CLIPTextModelWithProjection
    hidden_states[-2] and text_embeds (the projected pooled output, which
    diffusers' SD3 pipeline uses; the JAX package caches the unprojected
    pooler_output), without an attention mask."""
    import transformers
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.sd3 import CLIPPromptEncoder

    torch.manual_seed(0)
    hf = CLIPTextModelWithProjection(CLIPTextConfig(
        vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=2, max_position_embeddings=77, projection_dim=12,
        eos_token_id=63)).eval()
    (tmp_path / "config.json").write_text(hf.config.to_json_string())
    safetensors_io.save_file({k: v.contiguous() for k, v in hf.state_dict().items()},
                             tmp_path / "model.safetensors")
    ids = torch.full((2, 77), 63)
    ids[:, 0] = 62
    ids[0, 1:6] = torch.arange(1, 6)
    ids[1, 1:12] = torch.arange(10, 21)

    class Tokenizer:
        def __call__(self, captions, **kw):
            assert kw["max_length"] == 77 and kw["padding"] == "max_length"
            return {"input_ids": ids[:len(captions)]}

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path: Tokenizer()))
    hidden, pooled = CLIPPromptEncoder(str(tmp_path), str(tmp_path), "cpu")(["a", "b"])
    with torch.no_grad():
        out = hf(input_ids=ids, output_hidden_states=True)
    np.testing.assert_allclose(hidden.numpy(), out.hidden_states[-2].numpy(), atol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), out.text_embeds.numpy(), atol=1e-5)
    with torch.no_grad():
        unprojected = hf.text_model(input_ids=ids).pooler_output
    assert pooled.shape == (2, 12) and unprojected.shape == (2, 16)
