"""The port's counterpart of the top-level bench.py, on one CUDA card:

    python -m diffusion_pipe_tpu_torch.bench

Runs bench.py's two rows with bench.py's configurations, through the entry
points a user calls (get_model_class -> init_train_state ->
make_train_step), with random weights and inputs from fixed seeds:

- Flux-dev at full width and depth, fp8 block weights pre-quantized to
  int8, int8_matmul "fwd_bwd", LoRA r32, adamw8bit, clip 1.0,
  activation_checkpointing "attn"; batch 2 of 16x64x64 latents (512 px)
  with 512 T5 tokens; one warm-up step, then 10 timed;
- Wan2.1-1.3B t2v, LoRA r32, adamw8bit, clip 1.0, "attn"; batch 1 of
  16x21x64x64 latents (81 frames at 512 px) with 512 UMT5 tokens of width
  4096 and seq_lens 512; one warm-up step, then 3 timed.

It prints bench.py's one JSON line: metric, value (Flux samples/s), unit,
vs_baseline (against 1.0 sample/s) and extra
{"wan_1_3b_t2v_512px81f_lora_samples_per_sec_chip": ...}. A step's time
is host time over the timed steps, ended by torch.cuda.synchronize(). No
error is caught: a failing row fails the run.
"""

from __future__ import annotations

import json
import sys
import time

import torch

BASELINE_SAMPLES_PER_SEC = 1.0

FLUX_CONFIG = {
    "save_every_n_epochs": 1,
    "model": {
        "type": "flux",
        "dtype": "bfloat16",
        "transformer_dtype": "float8",
        "int8_matmul": "fwd_bwd",
        "guidance": 1.0,
    },
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": "attn",
}
FLUX_BATCH = dict(batch_size=2, latent_hw=64, txt_len=512, timed_steps=10)

WAN_CONFIG = {
    "save_every_n_epochs": 1,
    "model": {"type": "wan", "dtype": "bfloat16", "variant": "t2v-1.3b"},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": "attn",
}
WAN_BATCH = dict(batch_size=1, latent_fhw=(21, 64, 64), txt_len=512, timed_steps=3)


def _trainer(config, device):
    from .models import get_model_class
    from .training.optimizers import get_optimizer
    from .training.train_state import lora_predicate
    from .training.trainer import init_train_state, make_train_step

    pipeline = get_model_class(config["model"]["type"])(config, device=device)
    state = init_train_state(pipeline, get_optimizer(config),
                             torch.Generator(device=device).manual_seed(0), lora_predicate)
    step = make_train_step(pipeline, gradient_clipping=config["gradient_clipping"])
    return pipeline, state, step


def _timed(state, step, batch, timed_steps, device):
    """Seconds a step over `timed_steps` steps after one warm-up step."""
    gen = torch.Generator(device=device)
    step(state, batch, gen.manual_seed(2))["loss"].item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(timed_steps):
        metrics = step(state, batch, gen.manual_seed(3 + i))
    metrics["loss"].item()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / timed_steps


def bench_flux(device="cuda") -> float:
    """Samples/s of bench.py's Flux row."""
    pipeline, state, step = _trainer(FLUX_CONFIG, device)
    fc, b = pipeline.flux_config, FLUX_BATCH
    gen = torch.Generator(device=device).manual_seed(1)
    hw = b["latent_hw"]
    batch = {
        "latents": torch.randn((b["batch_size"], 16, hw, hw), generator=gen, device=device),
        "t5_embed": torch.randn((b["batch_size"], b["txt_len"], fc.joint_attention_dim),
                                generator=gen, device=device).to(torch.bfloat16),
        "clip_embed": torch.randn((b["batch_size"], fc.pooled_projection_dim), generator=gen,
                                  device=device).to(torch.bfloat16),
    }
    return b["batch_size"] / _timed(state, step, batch, b["timed_steps"], device)


def bench_wan_1_3b(device="cuda") -> float:
    """Samples/s of bench.py's Wan row."""
    pipeline, state, step = _trainer(WAN_CONFIG, device)
    wc, b = pipeline.wan_config, WAN_BATCH
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {
        "latents": torch.randn((b["batch_size"], wc.in_dim, *b["latent_fhw"]), generator=gen,
                               device=device),
        "text_embeddings": torch.randn((b["batch_size"], b["txt_len"], wc.text_dim),
                                       generator=gen, device=device).to(torch.bfloat16),
        "seq_lens": torch.full((b["batch_size"],), b["txt_len"], dtype=torch.int32,
                               device=device),
    }
    return b["batch_size"] / _timed(state, step, batch, b["timed_steps"], device)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: CUDA is not available", file=sys.stderr)
        return 2
    flux_sps = bench_flux()
    torch.cuda.empty_cache()
    wan_sps = bench_wan_1_3b()
    print(json.dumps({
        "metric": "samples/sec/chip Flux-dev(12B,fp8+int8) LoRA-r32 @512px",
        "value": round(flux_sps, 4),
        "unit": "samples/sec/chip",
        "vs_baseline": round(flux_sps / BASELINE_SAMPLES_PER_SEC, 3),
        "extra": {"wan_1_3b_t2v_512px81f_lora_samples_per_sec_chip": round(wan_sps, 4)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
