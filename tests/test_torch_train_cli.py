"""The port's training driver, python -m diffusion_pipe_tpu_torch.train, end
to end on the CPU at tiny width.

A dataset of PNGs with captions (two aspect-ratio buckets) and an eval set,
a TOML shaped like examples/flux.toml (tiny Flux, LoRA, adamw8bit, "attn"
checkpointing, eval every 2 steps, an export every epoch), and the same
TOML for tiny Wan t2v (its seeded VAE and UMT5-shaped text draws; the
images as one-frame videos):
- --cache_only fills the latent and text-embedding caches and stops;
- a run of 4 steps trains, evaluates at the 9 quantiles, exports the
  adapter (the JAX export's key count: diffusers-lora for Flux, ComfyUI
  for Wan) and checkpoints; resumed, it takes 2
  more steps. Its losses, eval losses, loader position and final LoRA
  factors equal those of an uninterrupted 6-step run, bit for bit;
- `-m` runs the same main; without --device it needs CUDA;
- a resume with --reset_dataloader, --reset_optimizer or
  --reset_optimizer_params restarts the loader, the optimizer state, or the
  LR schedule only; --profile_steps writes a trace;
- tiny SDXL (captions tokenized in the step, its seeded VAE) with LoRA: 2
  steps, a resume to 3 against an uninterrupted 3-step run, and the kohya
  adapter export (510 keys, as the JAX export gives them); with full
  fine-tuning (three LR groups): 2 steps and the single-file export;
- tiny SD3 and Chroma (their seeded VAEs and `_tiny` text draws, Chroma's
  with a T5 mask) through the same cache -> 4 steps -> resume against a
  straight run, and their adapters (the generic keymap export, with
  alpha entries);
- tiny Qwen-Image the same way (its seeded Wan 2.1 VAE, the `_tiny` text
  draws with their mask); tiny Qwen-Image-Edit trains on a control_path
  dataset, the control latents in every training batch;
- tiny FLUX.2 (the published layout, its seeded KL VAE, the `_tiny` text
  draws) and tiny AuraFlow (the seeded SDXL-shaped VAE; a 32 x 32 position
  table) the same way, their adapters in the ComfyUI dialect;
- tiny Lumina 2, Z-Image and OmniGen2 (the seeded Flux VAE, the JAX
  `_tiny` hooks' caption draws with their masks, Z-Image's pad tokens) the
  same way, their adapters in the ComfyUI dialect (NextDiT's fused qkv,
  OmniGen2's diffusers names);
- tiny HiDream (the seeded Flux VAE, the JAX `_tiny` hook's T5, pooled and
  two-layer Llama draws; MoE experts with their own adapters) the same
  way, its adapter in the ComfyUI dialect;
- tiny HunyuanVideo (its seeded causal 3D VAE, the JAX `_tiny` hook's
  LLaVA and CLIP draws) and tiny HunyuanImage-2.1 (the seeded KL VAE, the
  Qwen and byT5 draws) the same way, their adapters in the `transformer.`
  and the ComfyUI dialects;
- tiny Flux full fine-tuning writes model.safetensors in the diffusers
  layout;
- a [model] checkpoint path that does not load (a wrong path, a missing
  key, a key the model does not take) stops the driver;
- the options and families not ported yet raise NotImplementedError, and
  so does a full fine-tuning export without a keymap.
"""

import json
import runpy
import sys

import numpy as np
import pytest
import torch

from diffusion_pipe_tpu_torch import train
from torch_port_helpers import one_torch_thread  # noqa: F401

CONFIG = """output_dir = "{out}"
dataset = "{root}/dataset.toml"
eval_datasets = ["{root}/eval.toml"]
epochs = 10
micro_batch_size_per_gpu = 2
gradient_accumulation_steps = 1
gradient_clipping = 1.0
save_every_n_epochs = 1
eval_every_n_steps = 2
activation_checkpointing = "attn"
{extra}
[model]
type = "flux"
dtype = "float32"
_tiny = true

[adapter]
type = "lora"
rank = 4

[optimizer]
type = "adamw8bit"
lr = 1e-3
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("cli")
    for name, n, seed in (("train", 6, 0), ("eval", 2, 100)):
        (root / name).mkdir()
        for i in range(n):
            rng = np.random.default_rng(seed + i)
            w, h = (64, 64) if i % 3 else (96, 48)
            Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
                root / name / f"im{i}.png")
            (root / name / f"im{i}.txt").write_text(f"{name} picture {i}")
    (root / "dataset.toml").write_text(
        'resolutions = [64]\nenable_ar_bucket = true\nnum_ar_buckets = 3\n'
        f'[[directory]]\npath = "{root}/train"\n')
    (root / "eval.toml").write_text(f'resolutions = [64]\n[[directory]]\npath = "{root}/eval"\n')
    return root


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The JSONL mirror only: tensorboard's import is slow and optional."""
    monkeypatch.setitem(sys.modules, "tensorboard", None)


def _config(root, out, extra=""):
    path = root / f"{out}.toml"
    path.write_text(CONFIG.format(out=root / out, root=root, extra=extra))
    return str(path)


def _run_dir(root, out):
    (run,) = (root / out).iterdir()
    return run


def _records(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def _wan_config(root, out):
    path = _config(root, out)
    with open(path) as f:
        text = f.read().replace('type = "flux"', 'type = "wan"')
    with open(path, "w") as f:
        f.write(text)
    return path


def test_cache_train_eval_checkpoint_resume(root):
    _cache_train_resume(root, _config, "flux", 2 * (14 * 2 + 6 * 2))


def test_wan_cache_train_eval_checkpoint_resume(root):
    # 10 LoRA linears in each of the 2 blocks, lora_A and lora_B each
    _cache_train_resume(root, _wan_config, "wan", 2 * 10 * 2)


def _cache_train_resume(root, make_config, family, adapter_keys):
    """--cache_only, 4 steps with eval and a checkpoint, a resume to 6,
    against an uninterrupted 6-step run."""
    cfg = make_config(root, f"{family}_resumed")
    assert train.main(["--config", cfg, "--device", "cpu", "--cache_only"]) == 0
    caches = sorted(p.name for p in (root / "train" / "cache" / family).iterdir())
    assert caches == ["cache_64x64x1", "cache_96x32x1", "metadata.json"]
    assert not (root / f"{family}_resumed").exists()

    assert train.main(["--config", cfg, "--device", "cpu", "--max_steps", "4"]) == 0
    run = _run_dir(root, f"{family}_resumed")
    assert (run / "latest").read_text() == "global_step4"
    recs = _records(run)
    assert [r["step"] for r in recs if "train/loss" in r] == [1, 2, 3, 4]
    evals = [r for r in recs if "eval/eval/loss" in r]
    assert [r["step"] for r in evals] == [0, 2, 4]
    assert all(f"eval/eval/loss_quantile_{q / 10:.1f}" in r for r in evals for q in range(1, 10))
    assert all(np.isfinite(r["train/loss"]) for r in recs if "train/loss" in r)
    from safetensors.numpy import load_file

    adapter = load_file(str(run / "epoch1" / "adapter_model.safetensors"))
    assert len(adapter) == adapter_keys  # the JAX export's keys

    assert train.main(["--config", cfg, "--device", "cpu", "--resume_from_checkpoint",
                       "--max_steps", "6"]) == 0
    assert train.main(["--config", make_config(root, f"{family}_straight"), "--device", "cpu",
                       "--max_steps", "6"]) == 0
    straight = _run_dir(root, f"{family}_straight")
    strip = [{k: v for k, v in r.items() if k not in ("time", "eval/eval/eval_time_sec")}
             for r in _records(run)]
    strip_straight = [{k: v for k, v in r.items() if k not in ("time", "eval/eval/eval_time_sec")}
                      for r in _records(straight)]
    assert [r["step"] for r in strip if "train/loss" in r] == [1, 2, 3, 4, 5, 6]
    assert strip == strip_straight
    for name in ("client_state.json",):
        assert ((run / "global_step6" / name).read_text()
                == (straight / "global_step6" / name).read_text())
    a = torch.load(run / "global_step6" / "state.pt", weights_only=True)
    b = torch.load(straight / "global_step6" / "state.pt", weights_only=True)
    assert a["step"] == b["step"] == 6 and a["examples"] == b["examples"] == 12
    for k, v in b["trainable"].items():
        assert torch.equal(a["trainable"][k], v), k
    for sa, sb in zip(a["optimizer"], b["optimizer"]):
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) if torch.is_tensor(sb[k]) else sa[k] == sb[k]
                   for k in sb)


def _family_config(family, model_line=""):
    def make(root, out):
        path = _config(root, out)
        with open(path) as f:
            text = f.read().replace('type = "flux"', f'type = "{family}"\n{model_line}')
        with open(path, "w") as f:
            f.write(text)
        return path

    return make


def test_sd3_cache_train_eval_checkpoint_resume(root):
    # the scanned block's 14 LoRA linears and the final block's 11: lora_A,
    # lora_B and alpha each (the JAX export's 50 factors and 25 alphas)
    _cache_train_resume(root, _family_config("sd3"), "sd3", (14 + 11) * 3)


def test_qwen_image_cache_train_eval_checkpoint_resume(root):
    # 2 blocks x 14 LoRA linears: lora_A, lora_B and alpha each
    _cache_train_resume(root, _family_config("qwen_image"), "qwen_image", 2 * 14 * 3)


def test_flux2_cache_train_eval_checkpoint_resume(root):
    # 2 double blocks x 8 LoRA linears and 2 single blocks x 2: lora_A,
    # lora_B and alpha each
    _cache_train_resume(root, _family_config("flux2"), "flux2", (2 * 8 + 2 * 2) * 3)


def test_auraflow_cache_train_eval_checkpoint_resume(root):
    # 2 joint blocks x 16 LoRA linears and 2 single blocks x 8, with their
    # alphas; a 32 x 32 position table covers the tiny VAE's 16 x 16 and
    # 24 x 8 patch grids
    _cache_train_resume(root, _family_config("auraflow", "pos_embed_max_size = 1024"),
                        "auraflow", (2 * 16 + 2 * 8) * 3)


@pytest.mark.parametrize("family, pairs", [("lumina_2", 5), ("z_image", 5), ("omnigen2", 7)])
def test_lumina2_families_cache_train_eval_checkpoint_resume(root, family, pairs):
    # 2 main blocks and 1 + 1 refiners; NextDiT's fused qkv and 4 more LoRA
    # pairs a block, OmniGen2's separate q, k, v and 4 more: lora_A, lora_B
    # and alpha each
    _cache_train_resume(root, _family_config(family), family, 4 * pairs * 3)


def test_hidream_cache_train_eval_checkpoint_resume(root):
    # 2 double blocks of 27 adapted linears (adaLN, 8 attention, the shared
    # expert's 3, 4 routed experts' 3, ff_t's 3) and 2 single blocks of 20:
    # lora_A, lora_B and alpha each
    _cache_train_resume(root, _family_config("hidream"), "hidream", (2 * 27 + 2 * 20) * 3)


@pytest.mark.parametrize("family, pairs", [("cosmos_predict2", 16), ("anima", 16),
                                           ("cosmos", 16)])
def test_cosmos_families_cache_train_eval_checkpoint_resume(root, family, pairs):
    # 2 blocks of 16 LoRA linears (10 attention and MLP, 6 modulation):
    # lora_A, lora_B and alpha each; Anima's trained LLMAdapter beside them
    _cache_train_resume(root, _family_config(family), family, 2 * pairs * 3)
    if family == "anima":
        from safetensors.numpy import load_file

        run = _run_dir(root, "anima_resumed")
        adapter = load_file(str(run / "epoch1" / "llm_adapter.safetensors"))
        trained = torch.load(run / "global_step6" / "state.pt", weights_only=True)["trainable"]
        assert adapter and all(k.startswith("llm_adapter.") for k in adapter)
        assert sum(k.startswith("llm_adapter.") for k in trained) == len(adapter)


@pytest.mark.parametrize("family", ["hunyuan-video", "hunyuan_image"])
def test_hunyuan_families_cache_train_eval_checkpoint_resume(root, family):
    # 2 double blocks of 10 LoRA linears and 2 single blocks of 3: lora_A,
    # lora_B and alpha each
    _cache_train_resume(root, _family_config(family), family, (2 * 10 + 2 * 3) * 3)


@pytest.mark.parametrize("family", ["hunyuan_video_1.5", "ltx-video", "ltx2"])
def test_ltx_hv15_families_cache_train_eval_checkpoint_resume(root, family):
    # 2 blocks of 10 LoRA linears (HunyuanVideo-1.5's double blocks: fused
    # qkv, proj, MLP and modulation of each stream; LTX's q, k, v, out of
    # both attentions and the MLP): lora_A, lora_B and alpha each
    _cache_train_resume(root, _family_config(family), family, 2 * 10 * 3)


def test_qwen_image_edit_trains_on_control_images(root):
    """qwen_image_edit with a control_path dataset: the control images'
    latents are cached beside the targets' and ride in the batch, the
    text function receives the control files; 2 steps and the export."""
    import shutil

    ctrl = root / "edit_control"
    if not ctrl.exists():
        shutil.copytree(root / "train", ctrl)
    (root / "edit_dataset.toml").write_text(
        'resolutions = [64]\nenable_ar_bucket = true\nnum_ar_buckets = 3\n'
        f'[[directory]]\npath = "{root}/train"\ncontrol_path = "{ctrl}"\n')
    cfg = _family_config("qwen_image_edit")(root, "qwen_edit")
    with open(cfg) as f:
        text = f.read().replace(f"{root}/dataset.toml", f"{root}/edit_dataset.toml")
    with open(cfg, "w") as f:
        f.write(text.replace("eval_every_n_steps = 2", "eval_every_n_steps = 100"))
    from diffusion_pipe_tpu_torch.models import qwen_image

    seen = []
    real = qwen_image.QwenImagePipeline.prepare_inputs

    def spy(self, batch, *a, **kw):  # the eval set has no control images
        if "control_latents" in batch:
            seen.append(batch["control_latents"].shape == batch["latents"].shape)
        return real(self, batch, *a, **kw)

    qwen_image.QwenImagePipeline.prepare_inputs = spy
    try:
        assert train.main(["--config", cfg, "--device", "cpu", "--max_steps", "2"]) == 0
    finally:
        qwen_image.QwenImagePipeline.prepare_inputs = real
    assert len(seen) == 2 and all(seen)
    run = _run_dir(root, "qwen_edit")
    assert [r["step"] for r in _records(run) if "train/loss" in r] == [1, 2]


@pytest.mark.parametrize("case", ["wrong_path", "truncated", "extra_key"])
def test_a_named_checkpoint_loads_or_raises(root, case):
    """A [model] checkpoint path that does not load stops the driver: a
    mistyped path, a file missing a key, a file with a key the model does
    not take. Random init is only for a [model] that names no checkpoint."""
    from diffusion_pipe_tpu_torch import safetensors_io
    from diffusion_pipe_tpu_torch.config import load_config
    from diffusion_pipe_tpu_torch.models import get_model_class

    ckpt = root / "flux_ckpt" / "model.safetensors"
    if not ckpt.exists():
        pipe = get_model_class("flux")(load_config(_config(root, "ckpt_src")), device="cpu")
        pipe.init_params(torch.Generator().manual_seed(0))
        pipe.save_model(ckpt.parent, pipe.model)
    sd = safetensors_io.load_file(ckpt)
    path, error = root / f"ckpt_{case}.safetensors", KeyError
    if case == "wrong_path":
        path, error = root / "no_such_checkpoint", FileNotFoundError
    elif case == "truncated":
        sd.pop("single_transformer_blocks.1.proj_out.weight")
        match = "single_transformer_blocks.1.proj_out.weight"
    else:
        sd["transformer_blocks.0.attn.to_q2.weight"] = sd["proj_out.weight"]
        match = r"1 keys that the model does not take.*to_q2"
    if case != "wrong_path":
        safetensors_io.save_file(sd, path)
    else:
        match = "no safetensors found"
    cfg = _config(root, f"load_{case}")
    with open(cfg) as f:
        text = f.read().replace("_tiny = true", f'_tiny = true\ntransformer_path = "{path}"')
    with open(cfg, "w") as f:
        f.write(text)
    with pytest.raises(error, match=match):
        train.main(["--config", cfg, "--device", "cpu", "--max_steps", "1"])
    assert not (root / f"load_{case}").exists() or not any((root / f"load_{case}").rglob("*.pt"))


def test_chroma_cache_train_eval_checkpoint_resume(root):
    # a double block's 6 linears and 2 fused qkv, a single block's linear2
    # and fused linear1, in 2 + 2 blocks: lora_A, lora_B and alpha each
    _cache_train_resume(root, _family_config("chroma"), "chroma", (2 * 8 + 2 * 2) * 3)


def test_flux_full_fine_tuning_writes_the_diffusers_model(root):
    """Full fine-tuning (no [adapter]) for 1 step: the epoch export is
    model.safetensors in the diffusers layout, the trained weights."""
    from diffusion_pipe_tpu_torch import safetensors_io

    cfg = _config(root, "flux_full")
    with open(cfg) as f:
        text = f.read().replace("[adapter]\ntype = \"lora\"\nrank = 4\n", "")
    with open(cfg, "w") as f:
        f.write(text.replace("epochs = 10", "epochs = 1"))
    assert "[adapter]" not in text
    assert train.main(["--config", cfg, "--device", "cpu"]) == 0
    run = _run_dir(root, "flux_full")
    model = safetensors_io.load_file(run / "epoch1" / "model.safetensors")
    final = run / (run / "latest").read_text()
    trained = torch.load(final / "state.pt", weights_only=True)["trainable"]
    assert "transformer_blocks.0.attn.to_q.weight" in model
    assert "single_transformer_blocks.1.proj_out.bias" in model
    assert torch.equal(model["transformer_blocks.1.ff.net.2.weight"],
                       trained["double_blocks.1.ff_out.weight"])
    assert torch.equal(model["proj_out.weight"], trained["proj_out.weight"])
    assert len(model) == len(trained)


def _sdxl_config(root, out, full=False):
    path = _config(root, out, f"save_every_n_steps = {2 if full else 3}\n")
    with open(path) as f:
        text = f.read().replace('type = "flux"', 'type = "sdxl"')
    # no eval (its 9-quantile forwards would double the steps' time; the
    # chip smoke's driver-sdxl phase runs it) and, as examples/sdxl.toml,
    # no checkpointing
    text = text.replace("eval_every_n_steps = 2\n", "eval_before_first_step = false\n")
    text = text.replace('activation_checkpointing = "attn"\n', "")
    if full:  # no adapter: every UNet and tower weight trains, in three groups
        text = text.replace('[adapter]\ntype = "lora"\nrank = 4\n', "")
        text = text.replace('_tiny = true', '_tiny = true\nunet_lr = 2e-3\n'
                            'text_encoder_1_lr = 5e-4\ntext_encoder_2_lr = 0')
        text = text.replace('type = "adamw8bit"', 'type = "adamw"')
    with open(path, "w") as f:
        f.write(text)
    return path


def test_sdxl_lora_train_resume_and_kohya_export(root):
    """Captions reach host_prepare in the batch (no text cache); 2 steps,
    a resume to 3 equal to an uninterrupted run, the kohya adapter."""
    cfg = _sdxl_config(root, "sdxl_resumed")
    assert train.main(["--config", cfg, "--device", "cpu", "--max_steps", "2"]) == 0
    caches = sorted(p.name for p in (root / "train" / "cache" / "sdxl").iterdir())
    assert caches == ["cache_64x64x1", "cache_96x32x1", "metadata.json"]
    assert train.main(["--config", cfg, "--device", "cpu", "--resume_from_checkpoint",
                       "--max_steps", "3"]) == 0
    assert train.main(["--config", _sdxl_config(root, "sdxl_straight"), "--device", "cpu",
                       "--max_steps", "3"]) == 0
    run, straight = _run_dir(root, "sdxl_resumed"), _run_dir(root, "sdxl_straight")
    strip = [[{k: v for k, v in r.items() if k not in ("time", "eval/eval/eval_time_sec")}
              for r in _records(d)] for d in (run, straight)]
    assert [r["step"] for r in strip[0] if "train/loss" in r] == [1, 2, 3]
    assert strip[0] == strip[1]
    assert all(np.isfinite(r["train/loss"]) for r in strip[0] if "train/loss" in r)
    assert ((run / "global_step3" / "client_state.json").read_text()
            == (straight / "global_step3" / "client_state.json").read_text())
    a = torch.load(run / "global_step3" / "state.pt", weights_only=True)
    b = torch.load(straight / "global_step3" / "state.pt", weights_only=True)
    for k, v in b["trainable"].items():
        assert torch.equal(a["trainable"][k], v), k
    from safetensors.numpy import load_file

    adapter = load_file(str(run / "step3" / "adapter_model.safetensors"))
    # 17 transformer blocks x 10 LoRA linears x (lora_down, lora_up, alpha)
    assert len(adapter) == 17 * 10 * 3
    assert all(k.startswith("lora_unet_") for k in adapter)


def test_sdxl_full_fine_tuning_and_single_file_export(root):
    """Full fine-tuning (unet_lr, text_encoder_1_lr, text_encoder_2_lr = 0:
    bigG stays where it started), 2 steps and the step's single-file
    export."""
    from diffusion_pipe_tpu_torch import safetensors_io

    cfg = _sdxl_config(root, "sdxl_full", full=True)
    assert train.main(["--config", cfg, "--device", "cpu", "--max_steps", "2"]) == 0
    run = _run_dir(root, "sdxl_full")
    state = torch.load(run / "global_step2" / "state.pt", weights_only=True)["trainable"]
    assert any(k.startswith("text_encoder_2.") for k in state)
    model = safetensors_io.load_file(run / "step2" / "model.safetensors")
    assert any(k.startswith("model.diffusion_model.") for k in model)
    assert "conditioner.embedders.1.model.text_projection" in model
    te2 = {k.removeprefix("conditioner.embedders.1.model."): v for k, v in model.items()
           if k.startswith("conditioner.embedders.1.model.")}
    # lr 0: the exported bigG equals the seeded initialisation
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.models.sdxl_convert import convert_hf_clip_to_openclip
    from diffusion_pipe_tpu_torch.training.train_state import full_ft_predicate
    from diffusion_pipe_tpu_torch.training.trainer import init_train_state
    from diffusion_pipe_tpu_torch.config import load_config

    pipe = get_model_class("sdxl")(load_config(cfg), device="cpu")
    init_train_state(pipe, lambda params, names: None,
                     torch.Generator().manual_seed(load_config(cfg)["seed"]), full_ft_predicate)
    init = convert_hf_clip_to_openclip(pipe.model.text_encoder_2.state_dict())
    init["text_projection"] = init.pop("text_projection.weight").t()
    assert set(init) == set(te2)
    for k, v in init.items():
        assert torch.equal(te2[k], v), k
    # unet_lr 2e-3: every UNet tensor moved from the seeded initialisation
    unet = {k: v for k, v in state.items() if k.startswith("unet.")}
    unet_init = {f"unet.{k}": v for k, v in pipe.model.unet.state_dict().items()}
    assert unet and set(unet) == set(unet_init)
    for k, v in unet.items():
        assert not torch.equal(v, unet_init[k].to(v.dtype)), k


def test_module_entry_point_and_device_rule(root, monkeypatch):
    cfg = _config(root, "module")
    monkeypatch.setattr(sys, "argv", ["train", "--config", cfg, "--device", "cpu",
                                      "--max_steps", "1"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("diffusion_pipe_tpu_torch.train", run_name="__main__")
    assert done.value.code == 0
    assert (_run_dir(root, "module") / "global_step1" / "state.pt").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--config", cfg])


NOT_PORTED = {  # case: (TOML line to add, (TOML text, its replacement) or None, flags)
    "pipeline_stages": ("pipeline_stages = 2", None, []),
    "blocks_to_swap": ("blocks_to_swap = 2", None, []),
    "offload_optimizer": ("", ('type = "adamw8bit"', 'type = "offload"'), []),
    "wan": ("sequence_sharding = true", ('type = "flux"', 'type = "wan"'), []),
    "hunyuan-video": ("blocks_to_swap = 2", ('type = "flux"', 'type = "hunyuan-video"'), []),
    "hunyuan_video_15": ("", ('type = "flux"', 'type = "krea2"'), []),
}


@pytest.mark.parametrize("case", list(NOT_PORTED))
def test_not_ported_yet_raises(root, case):
    extra, replace, flags = NOT_PORTED[case]
    cfg = _config(root, f"np_{case}", extra)
    if replace is not None:
        with open(cfg) as f:
            text = f.read().replace(*replace)
        with open(cfg, "w") as f:
            f.write(text)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        train.main(["--config", cfg, "--device", "cpu", *flags])


def test_full_fine_tuning_export_raises(root):
    """A family with neither a keymap nor an export of its own."""
    from diffusion_pipe_tpu_torch.models.base import BasePipeline
    from diffusion_pipe_tpu_torch.training.saver import Saver

    cfg = {"save_every_n_epochs": 1, "model": {"type": "none"}}
    pipe = BasePipeline(cfg, device="cpu")
    pipe.model = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match="fully fine-tuned model"):
        Saver(cfg, root / "fullft", pipe).save_model("step1", None)


@pytest.mark.parametrize("flag", ["--reset_dataloader", "--reset_optimizer",
                                  "--reset_optimizer_params"])
def test_resume_resets(root, flag):
    """2 steps, then a resume of 1 step with the flag: the loader starts
    over, the optimizer state starts fresh, or the moments stay and the LR
    schedule restarts from the checkpoint's step."""
    out = "reset" + flag.replace("-", "_")
    cfg = _config(root, out, 'warmup_steps = 4')
    assert train.main(["--config", cfg, "--device", "cpu", "--max_steps", "2"]) == 0
    run = _run_dir(root, out)
    before = torch.load(run / "global_step2" / "state.pt", weights_only=True)
    assert train.main(["--config", cfg, "--device", "cpu", "--resume_from_checkpoint",
                       "--max_steps", "3", flag]) == 0
    after = torch.load(run / "global_step3" / "state.pt", weights_only=True)
    loader = json.loads((run / "global_step3" / "client_state.json").read_text())["custom_loader"]
    opt = after["optimizer"][0]
    assert after["step"] == 3
    if flag == "--reset_dataloader":
        assert loader == {"epoch": 1, "num_batches_pulled": 1}
        assert opt["step"] == 3 and "schedule_offset" not in opt
    elif flag == "--reset_optimizer":
        assert loader == {"epoch": 1, "num_batches_pulled": 3}
        assert opt["step"] == 1 and "schedule_offset" not in opt
    else:
        assert opt["step"] == 3 and opt["schedule_offset"] == 2
        assert not torch.equal(opt["m_q"], before["optimizer"][0]["m_q"])


def test_profile_steps_writes_a_trace(root):
    cfg = _config(root, "profiled")
    assert train.main(["--config", cfg, "--device", "cpu", "--max_steps", "3",
                       "--profile_steps", "1"]) == 0
    trace = _run_dir(root, "profiled") / "profile" / "trace.json"
    assert trace.exists() and json.loads(trace.read_text())["traceEvents"]
