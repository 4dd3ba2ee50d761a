"""Tiny Qwen-Image / Qwen-Image-Edit in the port vs the JAX package.

The `_tiny` config (2 blocks, 4 heads of 32, text 48 wide, f32) with LoRA
rank 4. Weights are seeded numpy draws on the JAX parameter structure
(tests/torch_port_helpers.py), LoRA B nonzero; they cross through
interop.py. The reference is the JAX package's submodules composed as the
published model computes (torch_port_helpers.qwen_one_silu): SiLU applied
to temb once, by each block and by the output norm, and the RoPE tables of
the port's ids (diffusers' QwenEmbedRope layout, held here against a table
written out by hand); the JAX QwenImageTransformer applies SiLU twice and
builds Flux's ids, and its whole output differs (checked). One jit gives
the reference loss and LoRA gradients at KEY for an edit batch (control
latents, a masked caption) and the JAX prepare_inputs of a t2i and an edit
batch at PREP_KEY; the noise and t are the JAX keys' draws.

Tolerances (f32): prepare_inputs 1e-5 (the ids are not the JAX ones, by
design); output 1e-4; loss 1e-5 relative; LoRA gradients 1e-4 abs / 1e-3
rel (f32 matmuls summed in another order); a trainer step's loss 1e-5
relative. The VAE: the diffusers AutoencoderKLQwenImage layout of a
seeded Wan 2.1 VAE loads to the same weights, and the latent table is
Wan 2.1's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import merge_params, partition_params
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models.qwen_image import qwen_rope_ids
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE, jax_draws, qwen_one_silu, random_params

KEY = jax.random.PRNGKey(4)
PREP_KEY = jax.random.PRNGKey(3)


def qwen_config(edit=False, **top):
    cfg = {"save_every_n_epochs": 1,
           "model": {"type": "qwen_image_edit" if edit else "qwen_image", "dtype": "float32",
                     "_tiny": True},
           "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.0},
           "optimizer": {"type": "adamw", "lr": 1e-3}}
    cfg.update(top)
    return cfg


def qwen_batch(seed, edit=False, masked=False):
    rng = np.random.default_rng(seed)
    mask = np.zeros((2, 8), np.int32)
    mask[0, :5], mask[1, :8] = 1, 1
    batch = {"latents": (rng.standard_normal((2, 16, 8, 12)) * 0.5).astype(np.float32),
             "prompt_embeds": rng.standard_normal((2, 8, 48)).astype(np.float32),
             "prompt_embeds_mask": mask}
    if edit:
        batch["control_latents"] = rng.standard_normal((2, 16, 8, 12)).astype(np.float32)
    if masked:
        batch["mask"] = (rng.random((2, 12, 20)) > 0.5).astype(np.float32)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_rope_ids_are_the_diffusers_layout():
    """diffusers' QwenEmbedRope(scale_rope=True) for a 2 x 3 packed grid and
    4 text tokens, and for an edit pair (control on frame 1), written out:
    rows -(h - h//2) .. h//2 - 1, columns likewise, text from max(h//2,
    w//2) on all three axes."""
    img, txt = qwen_rope_ids([(2, 3)], 4)
    want = [[0, -1, -2], [0, -1, -1], [0, -1, 0],
            [0, 0, -2], [0, 0, -1], [0, 0, 0]]
    assert img.tolist() == want
    assert txt.tolist() == [[1, 1, 1], [2, 2, 2], [3, 3, 3], [4, 4, 4]]
    img, txt = qwen_rope_ids([(2, 3), (2, 3)], 4)
    assert img.tolist() == want + [[1, r, c] for _, r, c in want]
    assert txt[0].tolist() == [1, 1, 1]
    img, txt = qwen_rope_ids([(4, 6)], 2)
    assert sorted({r for _, r, _ in img.tolist()}) == [-2, -1, 0, 1]
    assert sorted({c for _, _, c in img.tolist()}) == [-3, -2, -1, 0, 1, 2]
    assert txt.tolist() == [[3, 3, 3], [4, 4, 4]]


def _port_ids(batch, edit):
    h, w = batch["latents"].shape[-2:]
    img, txt = qwen_rope_ids([(h // 2, w // 2)] * (2 if edit else 1),
                             batch["prompt_embeds"].shape[1])
    return jnp.asarray(img.numpy()), jnp.asarray(txt.numpy())


@pytest.fixture(scope="module")
def jax_side():
    cfg = qwen_config(edit=True)
    pipe = jax_model_class("qwen_image_edit")(cfg)
    params = random_params(pipe, seed=5, lora_b_std=0.05)
    trainable, frozen = partition_params(params, jax_lora)
    batch = qwen_batch(11, edit=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jt2i = {k: jnp.asarray(v) for k, v in qwen_batch(12, masked=True).items()}
    jedit = {k: jnp.asarray(v) for k, v in qwen_batch(13, edit=True, masked=True).items()}
    img_ids, txt_ids = _port_ids(batch, edit=True)

    def inputs(p):
        mi, target, mask = pipe.prepare_inputs(KEY, jbatch)
        mi = dict(mi, img_ids=img_ids, txt_ids=txt_ids)
        return qwen_one_silu(pipe.model, p, **mi), target, mask

    def loss_fn(trainable):
        out, target, mask = inputs(merge_params(trainable, frozen))
        return pipe.loss_fn(out, target, mask), out

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(trainable):
        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        whole = pipe.model.apply(params, **pipe.prepare_inputs(KEY, jbatch)[0])
        return (out, loss, grads, whole, pipe.prepare_inputs(PREP_KEY, jt2i),
                pipe.prepare_inputs(PREP_KEY, jedit))

    out, loss, grads, whole, prep_t2i, prep_edit = run(trainable)
    return dict(cfg=cfg, pipe=pipe, params=params, batch=batch, out=np.asarray(out),
                loss=float(loss), whole=np.asarray(whole),
                grads=jax_to_state_dict(jax.tree.map(np.asarray, grads)),
                prep={"t2i": jax.tree.map(np.asarray, prep_t2i),
                      "edit": jax.tree.map(np.asarray, prep_edit)})


def port_pipeline(cfg, params):
    pipe = get_model_class(cfg["model"]["type"])(cfg, device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    pipe.model.load_state_dict(jax_to_state_dict(params))
    return pipe


def test_jax_module_applies_silu_twice_and_flux_ids(jax_side):
    assert np.abs(jax_side["whole"] - jax_side["out"]).max() > 1e-2


@pytest.mark.parametrize("mode", ["t2i", "edit"])
def test_prepare_inputs_matches(jax_side, mode):
    """The packing, the image-sequence-dependent t, control latents after
    the target's, the text mask, the loss mask and img_seq_len."""
    edit = mode == "edit"
    batch = qwen_batch(13 if edit else 12, edit=edit, masked=True)
    j_inputs, j_target, j_mask = jax_side["prep"][mode]
    noise, t = jax_draws(jax_side["pipe"], PREP_KEY, batch)
    pipe = port_pipeline(qwen_config(edit=edit), jax_side["params"])
    inputs, target, mask = pipe.prepare_inputs(_tbatch(batch), noise=noise, t=t)
    np.testing.assert_allclose(target.numpy(), j_target, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    for name in ("hidden_states", "encoder_hidden_states", "timestep", "txt_mask"):
        np.testing.assert_allclose(inputs[name].numpy(), np.asarray(j_inputs[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert inputs["img_seq_len"] == j_inputs["img_seq_len"] == 4 * 6
    assert inputs["hidden_states"].shape[1] == (48 if edit else 24)
    img_ids, txt_ids = _port_ids(batch, edit)
    np.testing.assert_array_equal(inputs["img_ids"].numpy(), img_ids)
    np.testing.assert_array_equal(inputs["txt_ids"].numpy(), txt_ids)


@pytest.mark.parametrize("remat", [False, "full", "attn", "dots", "offload_attn", "unsloth"])
def test_forward_and_lora_grads_match(jax_side, remat):
    """Output (cut to the target's rows) and every LoRA gradient, without
    and under each per-block checkpointing policy on the port's side."""
    ref = jax_side
    pipe = port_pipeline(dict(ref["cfg"], activation_checkpointing=remat), ref["params"])
    noise, t = jax_draws(ref["pipe"], KEY, ref["batch"])
    inputs, target, mask = pipe.prepare_inputs(_tbatch(ref["batch"]), noise=noise, t=t)
    for name, p in pipe.model.named_parameters():
        p.requires_grad_(lora_predicate(name))
    out = pipe.forward(inputs)
    assert out.shape == (2, 24, 64)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=1e-4, rtol=1e-4)
    loss = pipe.loss_fn(out, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    lora = {n: p for n, p in pipe.model.named_parameters() if p.requires_grad}
    assert set(lora) == set(ref["grads"]) and len(lora) == 2 * 14 * 2
    for name, p in lora.items():
        # the last block's text-stream output is unused: no gradient reaches
        # its text MLP (the JAX one is zero)
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), ref["grads"][name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_trainer_step_loss_matches(jax_side):
    """One step of the port's trainer from init_train_state over the JAX
    weights: its loss is the reference loss, and only LoRA factors move."""
    ref = jax_side
    pipe = get_model_class("qwen_image_edit")(ref["cfg"], device="cpu")
    state = init_train_state(pipe, get_optimizer(ref["cfg"]), torch.Generator().manual_seed(0),
                             lora_predicate, state_dict=jax_to_state_dict(ref["params"]))
    before = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    noise, t = jax_draws(ref["pipe"], KEY, ref["batch"])
    metrics = make_train_step(pipe, gradient_clipping=1.0)(state, _tbatch(ref["batch"]),
                                                           noise=noise, t=t)
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], rtol=1e-5)
    after = pipe.model.state_dict()
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    assert moved and all(lora_predicate(k) for k in moved)


def test_vae_reads_the_diffusers_layout(tmp_path):
    """A seeded Wan 2.1 VAE written in the diffusers AutoencoderKLQwenImage
    layout (the reference layout renamed by diffusers_key_map) loads back
    through load_wan_vae to the same weights; the pipeline reads it from
    <diffusers_path>/vae and normalises with Wan 2.1's table (below)."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models import wan_vae_convert as conv
    from diffusion_pipe_tpu_torch.models.wan_vae import WanVAEConfig, WanVideoVAE

    assert WanVideoVAE.latent_mean == [
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921]
    assert WanVideoVAE.latent_std == [
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160]
    cfg = WanVAEConfig(dim=8, dtype=torch.float32)
    vae = WanVideoVAE(cfg)
    vae.init_weights(torch.Generator().manual_seed(0))
    ref = conv.wan_vae_state_dict(vae)
    names = conv.diffusers_key_map(cfg)
    diffusers = {names[k]: v for k, v in ref.items()}
    assert "decoder.up_blocks.0.upsamplers.0.resample.1.weight" in diffusers
    assert "encoder.mid_block.attentions.0.to_qkv.weight" in diffusers
    assert "decoder.up_blocks.3.resnets.2.conv2.weight" in diffusers
    assert "quant_conv.weight" in diffusers and "post_quant_conv.bias" in diffusers
    assert conv.from_diffusers_layout(diffusers, cfg) == ref
    (tmp_path / "vae").mkdir()
    safetensors_io.save_file({k: v.contiguous() for k, v in diffusers.items()},
                             str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors"))
    got = conv.load_vae_checkpoint(WanVideoVAE, cfg, conv.convert_wan_vae(
        conv.from_diffusers_layout(safetensors_io.load_file(
            tmp_path / "vae" / "diffusion_pytorch_model.safetensors"), cfg), cfg))
    for k, v in vae.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    with pytest.raises(KeyError, match="outside the diffusers Wan layout"):
        conv.from_diffusers_layout({**diffusers, "encoder.extra.weight": ref["conv1.weight"]}, cfg)


def test_example_config_paths():
    """examples/qwen_image.toml as it is: the text encoder, tokenizer and
    VAE come from <diffusers_path>/{text_encoder, tokenizer, vae}, the
    layout is the published one; an edit config reads the same paths."""
    import tomllib

    from diffusion_pipe_tpu_torch.config import set_config_defaults

    with open("examples/qwen_image.toml", "rb") as f:
        cfg = set_config_defaults(tomllib.load(f))
    pipe = get_model_class("qwen_image")(cfg, device="cpu")
    c = pipe.qi_config
    assert (c.num_layers, c.num_attention_heads, c.attention_head_dim, c.joint_attention_dim,
            c.axes_dims_rope) == (60, 24, 128, 3584, (16, 56, 56))
    assert c.int8_matmul == "fwd_bwd" and c.base_kernel_dtype == torch.float8_e4m3fn
    assert c.lora_rank == 32 and c.remat == "full"
    assert pipe._path("text_encoder_path", "text_encoder") == "/models/Qwen-Image/text_encoder"
    assert pipe._path("vae_path", "vae") == "/models/Qwen-Image/vae"
    assert not {"text_encoder_path", "vae_path", "transformer_path"} & set(cfg["model"])


@pytest.fixture(scope="module")
def vl_folder(tmp_path_factory):
    """A tiny random transformers Qwen2.5-VL checkpoint (text 32 wide, 2
    layers, multimodal RoPE; vision 2 blocks, 16 wide, merged to 32) with a
    synthetic tokenizer holding the chat templates' special tokens, and a
    control image."""
    from PIL import Image
    from transformers import Qwen2_5_VLConfig, Qwen2_5_VLForConditionalGeneration

    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.models.qwen_image import EDIT_TEMPLATE, T2I_TEMPLATE
    from torch_port_helpers import write_qwen_tokenizer

    folder = tmp_path_factory.mktemp("qwen_vl")
    words = sorted(set((T2I_TEMPLATE + EDIT_TEMPLATE).split()) | {"a", "red", "cat", "dog"})
    vocab = write_qwen_tokenizer(folder, words)
    cfg = Qwen2_5_VLConfig(
        text_config=dict(vocab_size=len(vocab) + 8, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2, intermediate_size=48,
                         rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]},
                         rope_theta=1e6),
        vision_config=dict(depth=2, hidden_size=16, num_heads=2, intermediate_size=24,
                           out_hidden_size=32, window_size=56, fullatt_block_indexes=[1]),
        image_token_id=vocab["<|image_pad|>"], vision_start_token_id=vocab["<|vision_start|>"],
        video_token_id=len(vocab) + 1)
    torch.manual_seed(0)
    model = Qwen2_5_VLForConditionalGeneration(cfg)
    (folder / "config.json").write_text(cfg.to_json_string())
    safetensors_io.save_file({k: v.contiguous() for k, v in model.state_dict().items()},
                             str(folder / "model.safetensors"))
    rng = np.random.default_rng(0)
    Image.fromarray((rng.random((40, 64, 3)) * 255).astype(np.uint8)).save(folder / "ctrl.png")
    return folder


@pytest.mark.parametrize("mode", ["t2i", "edit"])
def test_text_functions_match_jax(vl_folder, mode, monkeypatch):
    """The pipelines' text functions on the same folder: t2i (chat
    template, the first 34 rows dropped, the final state) and edit (the
    control image through the vision tower at edit_image_size 56, spliced
    at <|image_pad|>, multimodal RoPE ids, 64 rows dropped), both towers
    in bf16 as the JAX pipeline runs them. Embeddings 3e-2 abs / 2e-2 rel
    (two bf16 decoders: measured 1.6e-2 at most, two bf16 ulps at 2),
    masks exactly; both give max_sequence_length rows (edit: plus the
    image's 4 merged tokens). The JAX edit function names Path without
    importing it (a NameError): the test supplies it."""
    edit = mode == "edit"
    cfg = qwen_config(edit=edit)
    cfg["model"] = {"type": cfg["model"]["type"], "dtype": "float32",
                    "text_encoder_dtype": "bfloat16", "text_encoder_path": str(vl_folder),
                    "max_sequence_length": 6, "edit_image_size": 56}
    import pathlib

    from diffusion_pipe_tpu.models import qwen_image as jqi

    # the JAX edit function uses Path without importing it (NameError)
    monkeypatch.setattr(jqi, "Path", pathlib.Path, raising=False)
    (jfn,) = jax_model_class(cfg["model"]["type"])(cfg).get_call_text_encoder_fns()
    (tfn,) = get_model_class(cfg["model"]["type"])(cfg, device="cpu").get_call_text_encoder_fns()
    caps = ["a red cat", "dog"]
    args = (caps, [str(vl_folder / "ctrl.png")] * 2) if edit else (caps,)
    want, got = jfn(*args), tfn(*args)
    assert got["prompt_embeds"].shape == (2, 6 + (4 if edit else 0), 32)
    np.testing.assert_array_equal(got["prompt_embeds_mask"].numpy(), want["prompt_embeds_mask"])
    assert got["prompt_embeds_mask"][0].sum() > got["prompt_embeds_mask"][1].sum() > 0
    np.testing.assert_allclose(got["prompt_embeds"].numpy(),
                               np.asarray(want["prompt_embeds"], np.float32), atol=3e-2, rtol=2e-2)
