"""The port's training driver:

    python -m diffusion_pipe_tpu_torch.train --config X.toml [--device cpu]
        [--resume_from_checkpoint [RUN]] [--regenerate_cache] [--cache_only]
        [--trust_cache] [--reset_dataloader] [--reset_optimizer]
        [--reset_optimizer_params] [--max_steps N] [--profile_steps N]
        [--test_sample PROMPT] [--dump_dataset DIR] [--i_know_what_i_am_doing]

Counterpart of the top-level train.py of the JAX package, on the same TOML
surface: the caching phase (dataset scan, aspect/size bucketing, latents
and text embeddings into the cache), the run directory, the train loop with
the 9-quantile eval, epoch and step triggers, checkpoints and resume, and
the adapter export. It runs on the card unless --device names another
device, and raises when CUDA is absent and no device was named.

Noise and timesteps of step N come from a generator seeded with N, and the
eval's from one seeded per (quantile, batch): a resumed run takes the steps
of an uninterrupted one. --profile_steps N writes a torch.profiler trace of
steps [1, N + 1) to run_dir/profile.

--dump_dataset DIR decodes up to 16 cached latents of each size bucket
back to PNGs (the first frame of a video) and exits after the caching
phase. --test_sample PROMPT samples one 512 x 512 latent (the Euler flow
sampler; DDIM for SDXL) in model.sample_steps steps (default 20) through
the initialised model, decodes it (a video's first frame) and writes
output_dir/example.png before training.

Not ported yet, each raising NotImplementedError: pipeline_stages or
tensor_parallel > 1 (ROADMAP A11), blocks_to_swap and the "offload"
optimizer (A10), and families other than Flux, Wan, SDXL, SD3, Chroma,
Qwen-Image, FLUX.2, AuraFlow, Lumina 2, Z-Image, OmniGen2, HiDream,
Cosmos-Predict2, Anima, Cosmos-1, HunyuanVideo and HunyuanImage-2.1 (A9).
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import sys
import time
from pathlib import Path

import torch

TIMESTEP_QUANTILES_FOR_EVAL = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
EVAL_SEED = 12345


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda, which must exist)")
    p.add_argument("--resume_from_checkpoint", nargs="?", const=True, default=False)
    p.add_argument("--regenerate_cache", action="store_true")
    p.add_argument("--cache_only", action="store_true")
    p.add_argument("--trust_cache", action="store_true")
    p.add_argument("--reset_dataloader", action="store_true")
    p.add_argument("--reset_optimizer", action="store_true")
    # keep the optimizer moments but restart the LR schedule
    p.add_argument("--reset_optimizer_params", action="store_true")
    p.add_argument("--dump_dataset", type=Path, default=None)
    p.add_argument("--i_know_what_i_am_doing", action="store_true")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--profile_steps", type=int, default=0)
    p.add_argument("--test_sample", type=str, default=None)
    return p.parse_args(argv)


def _check_ported(config, args):
    if int(config.get("pipeline_stages", 1)) > 1 or int(config.get("tensor_parallel", 1)) > 1:
        raise NotImplementedError(
            "pipeline_stages / tensor_parallel > 1 are not ported yet (ROADMAP A11)")
    if config.get("blocks_to_swap") or str(
            config.get("optimizer", {}).get("type", "")).lower() == "offload":
        raise NotImplementedError(
            "blocks_to_swap and optimizer.type = 'offload' are not ported yet (ROADMAP A10)")
    from .models import get_model_class
    from .models.auraflow import AuraFlowPipeline
    from .models.chroma import ChromaPipeline
    from .models.cosmos_predict2 import CosmosPredict2Pipeline
    from .models.flux import FluxPipeline
    from .models.flux2 import Flux2Pipeline
    from .models.hidream import HiDreamPipeline
    from .models.hunyuan_image import HunyuanImagePipeline
    from .models.hunyuan_video import HunyuanVideoPipeline
    from .models.hunyuan_video_15 import HunyuanVideo15Pipeline
    from .models.ltx2 import LTX2Pipeline
    from .models.ltx_video import LTXVideoPipeline
    from .models.lumina_2 import Lumina2Pipeline
    from .models.qwen_image import QwenImagePipeline
    from .models.sd3 import SD3Pipeline
    from .models.sdxl import SDXLPipeline
    from .models.wan import WanPipeline

    trained = (FluxPipeline, WanPipeline, SDXLPipeline, SD3Pipeline, ChromaPipeline,
               QwenImagePipeline, Flux2Pipeline, AuraFlowPipeline, Lumina2Pipeline,
               HiDreamPipeline, CosmosPredict2Pipeline, HunyuanVideoPipeline,
               HunyuanImagePipeline, HunyuanVideo15Pipeline, LTXVideoPipeline, LTX2Pipeline)
    if not issubclass(get_model_class(config["model"]["type"]), trained):
        raise NotImplementedError(
            f"the driver trains the Flux, Wan, SDXL, SD3, Chroma, Qwen-Image, FLUX.2, AuraFlow, "
            f"Lumina 2 (with Z-Image and OmniGen2), HiDream, Cosmos (Cosmos-Predict2, Anima "
            f"and Cosmos-1), HunyuanVideo, HunyuanImage-2.1, HunyuanVideo-1.5, LTX-Video and "
            f"LTX-2 (its video path) families so far; "
            f"{config['model']['type']!r} needs its VAE and text encoders ported (ROADMAP A9)")


# [model] keys that name the transformer's checkpoint (diffusers_path: its
# transformer/ or unet/ folder)
CHECKPOINT_KEYS = ("ckpt_path", "transformer_path", "single_file_path", "unet_path",
                   "checkpoint_path", "diffusers_path")


def pretrained_weights(pipeline):
    """The pipeline's pretrained weights (load_weights), or None for random
    init when [model] names no checkpoint at all (or sets the `_random_init`
    test hook, for runs whose diffusers folder holds only the VAE and
    tokenizer). A named checkpoint that fails to load raises: a wrong path,
    a missing key or one the model does not take."""
    mc = pipeline.model_config
    named = [k for k in CHECKPOINT_KEYS if mc.get(k)]
    if not named or mc.get("_random_init", False):
        print("no checkpoint in [model]: training from random init")
        return None
    state_dict = pipeline.load_weights()
    print(f"loaded pretrained weights (model.{named[0]})")
    return state_dict


def _to_png(image: torch.Tensor, path: Path) -> None:
    """image [3, H, W] (or [3, F, H, W]: its first frame) in [-1, 1] as an
    8-bit PNG, with Pillow."""
    from PIL import Image

    if image.dim() == 4:
        image = image[:, 0]
    arr = ((image.float().cpu() + 1) * 127.5).clamp(0, 255).permute(1, 2, 0)
    Image.fromarray(arr.numpy().astype("uint8")).save(path)


def dump_dataset(pipeline, train_data, out_dir: Path) -> int:
    """Decode up to 16 cached latents of every size bucket to
    out_dir/img_{n}.png; returns the count."""
    vae = pipeline._load_vae()
    out_dir.mkdir(parents=True, exist_ok=True)
    count = 0
    for bucket_ds in train_data.all_size_bucket_datasets():
        for i in range(min(len(bucket_ds), 16)):
            z = torch.as_tensor(bucket_ds[i]["latents"])[None].to(pipeline.device)
            with torch.no_grad():
                img = vae.decode(z)[0]
            _to_png(img, out_dir / f"img_{count}.png")
            count += 1
    print(f"dumped {count} decoded examples to {out_dir}")
    return count


def test_sample(pipeline, config, prompt: str, device) -> Path:
    """One 512 x 512 sample of `prompt` through the model as it stands,
    written to output_dir/example.png. The caption goes to the sampler too
    (SDXL encodes it with its towers)."""
    embeds = {}
    for fn in pipeline.get_call_text_encoder_fns():
        embeds.update(fn([prompt]))
    embeds = {k: torch.as_tensor(v).to(device) for k, v in embeds.items()}
    latents = pipeline.sample(width=512, height=512,
                              generator=torch.Generator(device=device).manual_seed(0),
                              num_steps=int(config.get("sample_steps", 20)), caption=prompt,
                              **embeds)
    with torch.no_grad():
        img = pipeline._load_vae().decode(latents)[0]
    out = Path(config["output_dir"]) / "example.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    _to_png(img, out)
    print(f"test sample written to {out}")
    return out


def _stop_profiler(profiler, run_dir: Path) -> None:
    profiler.stop()
    (run_dir / "profile").mkdir(exist_ok=True)
    profiler.export_chrome_trace(str(run_dir / "profile" / "trace.json"))
    print(f"profile written to {run_dir / 'profile'}")


def main(argv=None):
    args = parse_args(argv)

    from .common import resolve_device
    from .config import load_config, load_toml, lookup_batch_size, resolve_batch_size_maps
    from .data.dataset import Dataset
    from .data.loader import DatasetManager, PipelineDataLoader
    from .models import get_model_class
    from .training.metrics import MetricsWriter
    from .training.optimizers import get_optimizer
    from .training.saver import Saver, get_most_recent_run_dir
    from .training.trainer import init_train_state, make_eval_step, make_train_step

    config = load_config(args.config)
    _check_ported(config, args)
    device = resolve_device(args.device)
    dataset_config = load_toml(config["dataset"])
    bs_maps = resolve_batch_size_maps(config)
    pipeline = get_model_class(config["model"]["type"])(config, device=device)

    # --- caching phase ------------------------------------------------------
    support_video = pipeline.framerate is not None
    train_data = Dataset(dataset_config, pipeline, support_video=support_video)
    if not args.i_know_what_i_am_doing:
        for d in train_data.directories:
            n_res = len(d.resolutions or [])
            if n_res > 3:
                print(f"WARNING: {d.path} configures {n_res} resolutions. Each resolution "
                      "multiplies the size-bucket count. Re-run with "
                      "--i_know_what_i_am_doing to proceed anyway.")
                return 1
    eval_datasets = [(Path(p).stem, Dataset(load_toml(p), pipeline, support_video=support_video))
                     for p in config.get("eval_datasets", [])]
    manager = DatasetManager(pipeline, regenerate_cache=args.regenerate_cache,
                             trust_cache=args.trust_cache,
                             caching_batch_size=config.get("caching_batch_size", 1))
    manager.register(train_data)
    for _, ds in eval_datasets:
        manager.register(ds)
    manager.cache()
    if args.dump_dataset is not None:
        dump_dataset(pipeline, train_data, args.dump_dataset)
        return 0
    if args.cache_only:
        print("Cache generated. Exiting.")
        return 0

    # --- run dir ------------------------------------------------------------
    output_dir = Path(config["output_dir"])
    if args.resume_from_checkpoint is True:
        run_dir = Path(get_most_recent_run_dir(output_dir))
    elif args.resume_from_checkpoint:
        run_dir = output_dir / str(args.resume_from_checkpoint)
    else:
        run_dir = output_dir / datetime.datetime.now().strftime("%Y%m%d_%H-%M-%S")
        run_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(args.config, run_dir / Path(args.config).name)
        if os.path.exists(config["dataset"]):
            shutil.copy(config["dataset"], run_dir / Path(config["dataset"]).name)
    print(f"run_dir: {run_dir}")

    # --- weights / optimizer ------------------------------------------------
    gas = config["gradient_accumulation_steps"]
    train_data.post_init(0, 1, bs_maps["train"], gas,
                         image_micro_batch_size=bs_maps["image"], full_global=True)
    for _, ds in eval_datasets:
        ds.post_init(0, 1, bs_maps["eval"], config["eval_gradient_accumulation_steps"],
                     image_micro_batch_size=bs_maps["eval_image"], full_global=True)
    # one loader pull = gas microbatches = one optimizer step
    steps_per_epoch = max(1, len(train_data))
    if config.get("eval_every_n_examples"):
        bs = bs_maps["train"]
        bs = bs if isinstance(bs, int) else lookup_batch_size(bs, None)
        config["eval_every_n_steps"] = max(1, int(config["eval_every_n_examples"])
                                           // max(1, bs * gas))
        print(f"Computed eval_every_n_steps = {config['eval_every_n_steps']}")
    config["_total_steps"] = int(config.get("epochs", 1)) * steps_per_epoch
    base_lr = float(config.get("optimizer", {}).get("lr", 1e-4))
    # force_constant_lr overrides every LR group with one constant
    lr_scales = {} if "force_constant_lr" in config else pipeline.lr_scale_map(base_lr)
    optimizer = get_optimizer(config, lr_scales=lr_scales)

    state_dict = pretrained_weights(pipeline)
    if init_from_existing := config.get("adapter", {}).get("init_from_existing"):
        state_dict = {**(state_dict or {}), **pipeline.load_adapter(init_from_existing)}
        print(f"initialized adapter from {init_from_existing}")
    gen = torch.Generator(device=device)
    state = init_train_state(pipeline, optimizer, gen.manual_seed(config["seed"]),
                             pipeline.trainable_predicate(), state_dict=state_dict,
                             partial=True)
    del state_dict
    if args.test_sample is not None:
        test_sample(pipeline, config, args.test_sample, device)

    loader = PipelineDataLoader(train_data, gas)
    saver = Saver(config, run_dir, pipeline, dataloader=loader)
    if args.resume_from_checkpoint:
        state, _ = saver.load_checkpoint(state, reset_optimizer=args.reset_optimizer,
                                         reset_optimizer_params=args.reset_optimizer_params,
                                         reset_dataloader=args.reset_dataloader)
        print(f"resumed from step {state.step}")

    monitoring = config.get("monitoring", {})
    metrics_writer = MetricsWriter(run_dir, x_axis_examples=config.get("x_axis_examples", False),
                                   enable_wandb=monitoring.get("enable_wandb", False),
                                   wandb_config=monitoring or None)

    ocfg = config.get("optimizer", {})
    train_step = make_train_step(
        pipeline, gradient_clipping=config.get("gradient_clipping", 1.0),
        gradient_accumulation_steps=gas,
        skip_invalid_grads=bool(ocfg.get("skip_invalid_grads", False)),
        stochastic_rounding=bool(ocfg.get("stochastic_rounding", False)),
        gradient_release=bool(ocfg.get("gradient_release", False)))
    eval_step = make_eval_step(pipeline)

    def run_eval(step_i, examples):
        for name, ds in eval_datasets:
            eval_loader = PipelineDataLoader(ds, config["eval_gradient_accumulation_steps"])
            start = time.time()
            quantile_losses = {q: [] for q in TIMESTEP_QUANTILES_FOR_EVAL}
            for qi, q in enumerate(TIMESTEP_QUANTILES_FOR_EVAL):
                eval_loader.reset()
                for bi in range(ds.batches_per_epoch()):
                    _, batch = next(eval_loader)
                    # the noise differs per (quantile, batch), the same every eval
                    gen.manual_seed(EVAL_SEED + qi * 1_000_003 + bi)
                    loss = eval_step(pipeline.host_prepare(batch), gen, q)
                    quantile_losses[q].append(float(loss))
            out = {f"eval/{name}/loss_quantile_{q:.1f}": sum(v) / len(v)
                   for q, v in quantile_losses.items()}
            every = [x for v in quantile_losses.values() for x in v]
            out[f"eval/{name}/loss"] = sum(every) / len(every)
            out[f"eval/{name}/eval_time_sec"] = time.time() - start
            metrics_writer.write(out, step_i, examples)

    # --- train loop ---------------------------------------------------------
    step_i = state.step
    epoch = loader.epoch
    epoch_losses = []
    if config.get("eval_before_first_step", True) and not args.resume_from_checkpoint:
        run_eval(step_i, state.examples)

    max_steps = args.max_steps or config.get("max_steps", 10**12)
    profile_from = state.step + 1  # the first step of a run warms up: not profiled
    profiler = None
    while True:
        if args.profile_steps and step_i == profile_from:
            profiler = torch.profiler.profile()
            profiler.start()
        if profiler is not None and step_i == profile_from + args.profile_steps:
            _stop_profiler(profiler, run_dir)
            profiler = None
        _, batch = next(loader)
        batch = pipeline.host_prepare(batch)
        metrics = train_step(state, batch, gen.manual_seed(step_i))
        step_i += 1
        epoch_losses.append(float(metrics["loss"]))
        if step_i % config.get("logging_steps", 1) == 0:
            metrics_writer.write({f"train/{k}": float(v) for k, v in metrics.items()},
                                 step_i, state.examples)
            if int(metrics.get("skipped_params", 0)):
                print(f"WARNING: {int(metrics['skipped_params'])} parameter updates were "
                      "skipped due to Inf or NaN.")

        if loader.epoch != epoch:
            metrics_writer.write({"train/epoch_loss": sum(epoch_losses) / len(epoch_losses)},
                                 step_i, state.examples)
            epoch_losses = []
            if saver.process_epoch(state, epoch, step_i) is None:
                break
            epoch = loader.epoch
            if config.get("eval_every_n_epochs") and (epoch - 1) % config["eval_every_n_epochs"] == 0:
                run_eval(step_i, state.examples)

        if config.get("eval_every_n_steps") and step_i % config["eval_every_n_steps"] == 0:
            run_eval(step_i, state.examples)

        if saver.process_step(state, step_i, state.examples) or step_i >= max_steps:
            break

    if profiler is not None:
        _stop_profiler(profiler, run_dir)
    saver.save_checkpoint(state, step_i)
    metrics_writer.close()
    print(f"done at step {step_i}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
