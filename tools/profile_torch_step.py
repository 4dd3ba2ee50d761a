#!/usr/bin/env python3
"""Where the time of one of the port's training steps goes, on one GPU.

    python3 tools/profile_torch_step.py              # flux-dev-lora-512
    python3 tools/profile_torch_step.py --slice flux-fp8-int8
                                                     # flux-dev-lora-512-fp8-int8
    python3 tools/profile_torch_step.py --slice wan  # wan-1.3b-t2v-fullft-sr
    python3 tools/profile_torch_step.py --slice wan-lora  # wan-1.3b-t2v-lora-attn
    python3 tools/profile_torch_step.py --slice sdxl-lora # sdxl-lora-512
    python3 tools/profile_torch_step.py --slice sdxl-fullft  # sdxl-fullft
    python3 tools/profile_torch_step.py --slice sd3-lora  # sd3-medium-lora-1024
    python3 tools/profile_torch_step.py --slice chroma-lora  # chroma-lora-512
    python3 tools/profile_torch_step.py --slice qwen-lora  # qwen-image-lora-1024
    python3 tools/profile_torch_step.py --slice flux2-lora  # flux2-dev-lora-1024-fp8-int8
    python3 tools/profile_torch_step.py --slice auraflow-lora  # auraflow-v0.3-lora-1024
    python3 tools/profile_torch_step.py --slice lumina2-lokr  # lumina2-lokr-1024
    python3 tools/profile_torch_step.py --slice omnigen2-lora  # omnigen2-lora-1024
    python3 tools/profile_torch_step.py --slice hidream-lora  # hidream-i1-lora-1024
    python3 tools/profile_torch_step.py --slice anima-lora  # anima-lora-1024
    python3 tools/profile_torch_step.py --slice cosmos1-lora  # cosmos1-7b-lora-704x960
    python3 tools/profile_torch_step.py --slice hunyuan-video-lora  # hunyuan-video-lora-512x33
    python3 tools/profile_torch_step.py --slice hunyuan-image-lora  # hunyuan-image-2.1-lora-2048
    python3 tools/profile_torch_step.py --slice hunyuan-video-15-lora # hunyuan-video-15-lora-512x33
    python3 tools/profile_torch_step.py --slice ltx-video-lora  # ltx-video-2b-lora-768x512x121
    python3 tools/profile_torch_step.py --slice ltx2-lora  # ltx2-lora-768x512x121-fp8
    ... --checkpointing attn|true   # the slice with another checkpointing policy

Builds the path exactly as chip_smoke.py does (chip_smoke.build_slice:
full-width Flux-dev, LoRA r32, adamw8bit, per-block checkpointing, batch 2 at
512 px, with chip_smoke.FP8_INT8_CONFIG the same with fp8 block weights
pre-quantized to int8, int8_matmul "fwd_bwd" and "attn" checkpointing as
bench.py runs it; or chip_smoke.build_wan_slice: full-width Wan2.1-1.3B t2v, full
fine-tuning in bf16, adamw with stochastic rounding, per-block
checkpointing, one 81-frame 512 px clip; with chip_smoke.WAN_LORA_CONFIG
bench.py's Wan row: LoRA r32, adamw8bit, "attn"; or chip_smoke.build_sdxl_slice:
SDXL at full size, LoRA r16 with adamw8bit at batch 4 of 512 px, or full
fine-tuning with adamw at batch 1; or chip_smoke.build_sd3_slice: SD3-Medium,
LoRA r32, adamw8bit, per-block checkpointing, batch 2 at 1024 px; or
chip_smoke.build_chroma_slice: Chroma, LoRA r32, adamw8bit, "attn", batch 2
at 512 px with 512 masked T5 tokens; or chip_smoke.build_qwen_slice:
Qwen-Image at full size as examples/qwen_image.toml trains it, fp8
weights pre-quantized to int8, int8_matmul "fwd_bwd", LoRA r32, adamw8bit,
`true`, batch 2 at 1024 px with 512 masked text rows; or
chip_smoke.build_flux2_slice: FLUX.2 [dev] at its published size, fp8
weights pre-quantized to int8, int8_matmul "fwd_bwd", LoRA r32, adamw8bit,
`true`, batch 1 at 1024 px with 512 text rows; or
chip_smoke.build_auraflow_slice: AuraFlow v0.3 at full size, fp8 weights,
LoRA r32, adamw8bit, `true`, batch 2 at 1024 px with 256 text rows, its
attention at head dim 256; or chip_smoke.build_lumina_slice:
Lumina-Image-2.0 at its published size as examples/lumina_2.toml trains it,
LoKr and genericoptim, `true`, batch 2 at 1024 px with 256 masked caption
rows, its attention at head dim 96; with chip_smoke.OMNIGEN2_LORA_CONFIG
OmniGen2 at full width and 4 main blocks, LoRA r32, adamw8bit, batch 1,
head dim 120; or chip_smoke.build_hidream_slice: HiDream-I1 at its
published size in bf16, LoRA r32 on every block linear, the routed experts'
included, adamw8bit, `true`, batch 1 at 1024 px with 128 T5 rows and 32
Llama layers of 128 rows; or chip_smoke.build_cosmos_slice: Cosmos-Predict2
at its full 2 B size with Anima's LLMAdapter, LoRA r32, adamw8bit, `true`,
batch 2 at 1024 px with 512 T5 ids and 512 Qwen rows, or Cosmos-1 at its
full 7 B size under EDM, batch 1 at 960 x 704; or chip_smoke.build_hunyuan_slice:
HunyuanVideo at its published 12.8 B size in fp8 storage, LoRA r32 in bf16,
adamw8bit, `true`, one 33-frame 512 px clip with 256 LLaVA rows, or
HunyuanImage-2.1 at its published 17.4 B size in bf16, batch 1 at 2048 px
with 966 Qwen and 128 byT5 rows; or chip_smoke.build_ltx_hv15_slice:
HunyuanVideo-1.5 at its 8.3 B reading in bf16, one 33-frame 512 px clip with
966 Qwen and 128 byT5 rows, LTX-Video 2 B in bf16 with
first_frame_conditioning_p 0.5, or LTX-2's 12.9 B video path in fp8 storage,
each on one 121-frame 768 x 512 clip, LoRA r32, adamw8bit, `true`), builds the
kernels if needed, runs one warm-up step, then records two steps under
torch.profiler (CPU and CUDA activities). Prints one JSON line with:

- wall_ms_per_step: host clock around the recorded steps, ended by a
  synchronize (the profiler's own overhead included);
- device_busy_share: union of all device-kernel intervals over that wall
  window (1 - idle share), and device_busy_share_unprofiled: the same busy
  time over the unprofiled step time below;
- device_ms_per_step by kernel category: the three flash kernels, the
  stochastic-rounding kernel, the int8 quantization and rescale kernels
  (H1, H2), GEMMs (cuBLAS/CUTLASS names, the int8 ones included),
  everything else;
- the top 15 kernels by device time;
- the top 15 host operators by their own CPU time (torch.profiler's
  self_cpu_time_total) per step, with their calls per step;
- unprofiled host-clock times (each ended by a synchronize) of a whole step
  (the mean of three, and each),
  of forward + backward alone, of the global norm and clip alone, and of
  optimizer.step() alone;
- the matmul flops of one forward (torch.utils.flop_counter; the attention
  kernels are outside it; SDXL's convolutions are in it), the step's
  dense-product flops taken as one forward, one more for the checkpoint
  recompute when the path checkpoints, one for the input gradients and,
  under full fine-tuning, one for the weight gradients (the LoRA weight
  gradients add under 2%), and the rate the GEMM kernels reached on them;
- HiDream only (moe): the dense MoE of one double block (4,096 image rows)
  and of one single block (4,480 rows) timed alone with CUDA events, its
  routed experts apart from the shared one, forward and forward + backward
  (the step's backward through frozen bf16 weights with LoRA: the input
  gradient and the factors' gradients), their product flops and rates, the
  GEMM kernels' share of each (torch.profiler over the same calls), and
  the routed experts' time a step reckoned from them (16 double and 32
  single blocks, each forward twice under `true`, one backward), all of
  it and its GEMMs alone: the figures a routed grouped GEMM would start
  from.
"""

import argparse
import functools
import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GEMM = re.compile(r"gemm|xmma|nvjet|cutlass|sm90_", re.IGNORECASE)
KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
           "sr_add_kernel", "quant_rows_kernel", "rescale_kernel")
# K3 at head dim 256 (csrc/flash_bwd_dkv_d256.cu), counted with K3; K1's
# and K2's kernels have one name at every head dim
D256 = {"flash_bwd_dkv_d256": "flash_bwd_dkv_kernel"}
STEPS = 2


def category(name: str) -> str:
    for k, cat in D256.items():
        if k in name:
            return cat
    for k in KERNELS:
        if k in name:
            return k
    return "gemm" if GEMM.search(name) else "other"


def busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _host_ms(fn, n=3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def unprofiled(pipeline, state, step, batch, gen, sr):
    """Host-clock times without the profiler: a whole step, forward + backward
    alone, the global norm and clip alone and optimizer.step() alone (on the
    grads that backward left, with stochastic rounding when the path has
    it)."""
    from diffusion_pipe_tpu_torch.training.trainer import (clip_by_global_norm, global_norm,
                                                           make_loss_fn)

    loss_fn = make_loss_fn(pipeline)
    each = [_host_ms(lambda: step(state, batch, gen), n=1) for _ in range(3)]
    out = dict(step=sum(each) / len(each), step_each=each)
    out["forward_backward"] = _host_ms(lambda: loss_fn(batch, gen).backward())
    grads = [p.grad for p in state.trainable.values() if p.grad is not None]
    out["norm_and_clip"] = _host_ms(lambda: clip_by_global_norm(grads, global_norm(grads), 1.0))
    out["optimizer_step"] = _host_ms(
        lambda: state.optimizer.step(sr_step=state.step if sr else None))
    state.optimizer.zero_grad(set_to_none=True)
    return out


def _event_ms(fn, n=5):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _gemm_ms(fn, n=3):
    """The device time of fn's GEMM kernels a call (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA and category(e.name) == "gemm") / 1e3 / n


def moe_timing(pipeline):
    """The dense MoE of HiDream's first double and first single block, alone,
    on random rows at the slice's counts (see the module docstring)."""
    import chip_smoke

    c = pipeline.hd_config
    blocks = {"double": (pipeline.model.double_blocks[0].ff_i, 64 * 64),
              "single": (pipeline.model.single_blocks[0].ff_i,
                         chip_smoke._hidream_rows(c, 64 * 64))}
    out = {}
    for kind, (moe, rows) in blocks.items():
        x = torch.randn((1, rows, c.hidden_size), device="cuda", dtype=c.dtype,
                        requires_grad=True)
        gate = moe.gate_weights(x.detach()).to(c.dtype)

        def routed():
            return sum(gate[..., j:j + 1] * e(x) for j, e in enumerate(moe.experts))

        def fwd_bwd(fn):
            y = fn()
            y.backward(torch.ones_like(y))

        flops = 2 * rows * c.hidden_size * c.ff_hidden * 3 * c.num_routed_experts
        rec = dict(rows=rows, routed_forward_ms=_event_ms(lambda: routed().sum()),
                   routed_forward_backward_ms=_event_ms(lambda: fwd_bwd(routed)),
                   shared_forward_ms=_event_ms(lambda: moe.shared(x).sum()),
                   whole_forward_ms=_event_ms(lambda: moe(x).sum()),
                   routed_forward_flops=flops)
        for name, fn in (("forward", lambda: routed().sum()),
                         ("forward_backward", lambda: fwd_bwd(routed))):
            rec[f"routed_{name}_gemm_ms"] = _gemm_ms(fn)
        rec["routed_forward_tflops_per_s"] = flops / rec["routed_forward_ms"] / 1e9
        rec["routed_forward_backward_tflops_per_s"] = (
            2 * flops / rec["routed_forward_backward_ms"] / 1e9)
        out[kind] = rec
        x.grad = None
    # `true`: each block's forward again in the backward, then its backward
    n = {"double": c.num_double_layers, "single": c.num_single_layers}
    for part in ("", "_gemm"):
        out[f"routed{part}_ms_per_step"] = sum(
            n[k] * (out[k][f"routed_forward{part}_ms"]
                    + out[k][f"routed_forward_backward{part}_ms"]) for k in n)
    for p in pipeline.model.parameters():
        p.grad = None
    return out


def forward_matmul_flops(pipeline, batch, gen):
    from torch.utils.flop_counter import FlopCounterMode

    from diffusion_pipe_tpu_torch.training.trainer import make_loss_fn

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        make_loss_fn(pipeline)(batch, gen)
    return counter.get_total_flops()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slice", choices=("flux", "flux-fp8-int8", "wan", "wan-lora",
                                        "sdxl-lora", "sdxl-fullft", "sd3-lora",
                                        "chroma-lora", "qwen-lora", "flux2-lora",
                                        "auraflow-lora", "lumina2-lokr", "omnigen2-lora",
                                        "hidream-lora", "anima-lora", "cosmos1-lora",
                                        "hunyuan-video-lora", "hunyuan-image-lora",
                                        "hunyuan-video-15-lora", "ltx-video-lora",
                                        "ltx2-lora"),
                    default="flux")
    ap.add_argument("--checkpointing", choices=("true", "attn"), default=None,
                    help="activation_checkpointing in place of the slice's own")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke

    cell, cfg, build = {
        "wan": ("wan-1.3b-t2v-fullft-sr", chip_smoke.WAN_SLICE_CONFIG,
                chip_smoke.build_wan_slice),
        "wan-lora": ("wan-1.3b-t2v-lora-attn", chip_smoke.WAN_LORA_CONFIG,
                     chip_smoke.build_wan_slice),
        "flux-fp8-int8": ("flux-dev-lora-512-fp8-int8", chip_smoke.FP8_INT8_CONFIG,
                          chip_smoke.build_slice),
        "flux": ("flux-dev-lora-512", chip_smoke.SLICE_CONFIG, chip_smoke.build_slice),
        "sdxl-lora": ("sdxl-lora-512", chip_smoke.SDXL_LORA_CONFIG, chip_smoke.build_sdxl_slice),
        "sdxl-fullft": ("sdxl-fullft", chip_smoke.SDXL_FULLFT_CONFIG,
                        lambda cfg: chip_smoke.build_sdxl_slice(cfg, batch_size=1)),
        "sd3-lora": ("sd3-medium-lora-1024", chip_smoke.SD3_LORA_CONFIG,
                     chip_smoke.build_sd3_slice),
        "chroma-lora": ("chroma-lora-512", chip_smoke.CHROMA_LORA_CONFIG,
                        chip_smoke.build_chroma_slice),
        "qwen-lora": ("qwen-image-lora-1024", chip_smoke.QWEN_LORA_CONFIG,
                      chip_smoke.build_qwen_slice),
        "flux2-lora": ("flux2-dev-lora-1024-fp8-int8", chip_smoke.FLUX2_LORA_CONFIG,
                       chip_smoke.build_flux2_slice),
        "auraflow-lora": ("auraflow-v0.3-lora-1024", chip_smoke.AURAFLOW_LORA_CONFIG,
                          chip_smoke.build_auraflow_slice),
        "lumina2-lokr": ("lumina2-lokr-1024", chip_smoke.LUMINA2_LOKR_CONFIG,
                         chip_smoke.build_lumina_slice),
        "omnigen2-lora": ("omnigen2-lora-1024", chip_smoke.OMNIGEN2_LORA_CONFIG,
                          lambda cfg: chip_smoke.build_lumina_slice(cfg, valid=(200,))),
        "hidream-lora": ("hidream-i1-lora-1024", chip_smoke.HIDREAM_LORA_CONFIG,
                         chip_smoke.build_hidream_slice),
        "anima-lora": ("anima-lora-1024", chip_smoke.ANIMA_LORA_CONFIG,
                       lambda cfg: chip_smoke.build_cosmos_slice("anima", cfg)),
        "cosmos1-lora": ("cosmos1-7b-lora-704x960", chip_smoke.COSMOS1_LORA_CONFIG,
                         lambda cfg: chip_smoke.build_cosmos_slice(
                             "cosmos", cfg, latent_thw=(1, 88, 120), batch_size=1)),
        "hunyuan-video-lora": ("hunyuan-video-lora-512x33", chip_smoke.HUNYUAN_VIDEO_LORA_CONFIG,
                               lambda cfg: chip_smoke.build_hunyuan_slice("hunyuan-video", cfg)),
        "hunyuan-image-lora": ("hunyuan-image-2.1-lora-2048",
                               chip_smoke.HUNYUAN_IMAGE_LORA_CONFIG,
                               lambda cfg: chip_smoke.build_hunyuan_slice(
                                   "hunyuan_image", cfg, latent=(64, 64),
                                   txt=(chip_smoke.HI_TXT, chip_smoke.HI_VALID))),
        **{f"{name}-lora": (cell_, cfg_, functools.partial(chip_smoke.build_ltx_hv15_slice, fam))
           for name, fam in (("hunyuan-video-15", "hunyuan_video_15"),
                             ("ltx-video", "ltx-video"), ("ltx2", "ltx2"))
           for _, cell_, cfg_ in [chip_smoke.LTX_HV15_CELLS[fam]]},
    }[args.slice]
    if args.checkpointing:
        policy = True if args.checkpointing == "true" else args.checkpointing
        cfg = {**cfg, "activation_checkpointing": policy}
        cell += f" (activation_checkpointing {args.checkpointing})"
    pipeline, state, step, batch, gen = build(cfg)
    sr = bool(cfg["optimizer"].get("stochastic_rounding", False))
    forwards = (2 + bool(cfg.get("activation_checkpointing"))
                + ("adapter" not in cfg))
    step(state, batch, gen)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(state, batch, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device activity only: the GPU-side span of torch's own
    # "Optimizer.step#..." label is an annotation, not a kernel
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    by_cat = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_cat[category(e.name)] += dur
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    host_top = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:15]
    plain = unprofiled(pipeline, state, step, batch, gen, sr)
    fwd_flops = forward_matmul_flops(pipeline, batch, gen)
    extra = {"moe": moe_timing(pipeline)} if args.slice == "hidream-lora" else {}
    print(json.dumps(dict(
        cell=cell,
        device=torch.cuda.get_device_name(0),
        nvidia_smi=chip_smoke.nvidia_smi_line(),
        steps=STEPS,
        wall_ms_per_step=wall_us / 1e3 / STEPS,
        device_busy_share=busy / wall_us,
        kernel_launches_per_step=len(kernels) / STEPS,
        device_ms_per_step={k: v / 1e3 / STEPS for k, v in sorted(by_cat.items())},
        unprofiled_ms=plain,
        device_busy_share_unprofiled=busy / 1e3 / STEPS / plain["step"],
        forward_matmul_flops=fwd_flops,
        step_dense_flops=forwards * fwd_flops,
        gemm_tflops_per_s=forwards * fwd_flops / (by_cat["gemm"] / 1e6 / STEPS) / 1e12,
        top_kernels=[dict(name=n[:120], ms_per_step=v[0] / 1e3 / STEPS,
                          calls_per_step=v[1] / STEPS) for n, v in top],
        host_top_ops=[dict(name=a.key[:120], self_cpu_ms_per_step=a.self_cpu_time_total
                           / 1e3 / STEPS, calls_per_step=a.count / STEPS) for a in host_top],
        **extra,
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
