#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (diffusion_pipe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line:

1. build     -- compiles the CUDA kernels under diffusion_pipe_tpu_torch/csrc
                with nvcc, all sources in parallel, and reports nvcc's
                register and spill counts.
2. kernels   -- K1 (forward), K2 (dQ) and K3 (dK/dV) against their plain
                PyTorch versions at Flux-dev shapes (B=2, H=24, S=1536,
                D=128, bf16): unmasked, with a [B, Skv] text-padding mask,
                and at a ragged S=1000. Each kernel's error against the f32
                plain result must be at most twice the bf16 plain version's
                error plus 1e-3 of the reference's largest magnitude. At the
                main shape it times each kernel, its plain version and, as a
                yardstick only, torch's scaled_dot_product_attention.
3. reference -- a two-block Flux at head dim 128 (bf16 on the card, through
                the kernels) against the same weights in f32 on the CPU
                (plain attention): output, loss and LoRA grads.
4. slice     -- the main path: the full-width, full-depth Flux-dev LoRA-r32
                trainer (adamw8bit, clip 1.0, per-block activation
                checkpointing) at 512 px, batch 2, random weights and
                latents from a seed. One warm-up step, then five timed steps
                with the launch counters set to 0 just before: every loss
                finite, LoRA factors moved, frozen weights unchanged, and
                114 / 57 / 57 kernel launches per step.

Then it prints the kernels' JSON line, the card's name and power limit from
nvidia-smi, and last {"ok": true, "device": {...}}. Any failed check raises
and exits non-zero. Float32 references run with TF32 off (matmul and cuDNN).
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16, NVIDIA data sheet
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SEED = 0
TIMED_STEPS = 5
KERNEL_SOURCES = {
    "flash_fwd": ("diffusion_pipe_tpu_torch/csrc/flash_fwd.cu",
                  "diffusion_pipe_tpu/ops/flash_attention.py:59"),
    "flash_bwd_dq": ("diffusion_pipe_tpu_torch/csrc/flash_bwd_dq.cu",
                     "diffusion_pipe_tpu/ops/flash_attention.py:217"),
    "flash_bwd_dkv": ("diffusion_pipe_tpu_torch/csrc/flash_bwd_dkv.cu",
                      "diffusion_pipe_tpu/ops/flash_attention.py:264"),
}


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def emit(**record):
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters=20):
    """Mean device time of fn() over `iters` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --- phase 1 ------------------------------------------------------------------


def phase_build():
    from diffusion_pipe_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    report = kernel_build.build_all()
    ptxas = {
        name: [ln.strip() for ln in r["ptxas"].splitlines()
               if "registers" in ln or "spill" in ln]
        for name, r in report.items()
    }
    emit(phase="build", seconds=time.perf_counter() - t0,
         per_source_seconds={n: r["seconds"] for n, r in report.items()},
         cached={n: r["cached"] for n, r in report.items()}, ptxas=ptxas)


# --- phase 2 ------------------------------------------------------------------


def _attn_inputs(b, s, h, d, masked, gen):
    dev = "cuda"
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    mask = None
    if masked:
        # text padding: element 0 keeps 300 of its 512 text tokens, element 1
        # all of them; image tokens (after the text) are always valid
        mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        mask[0, 300:512] = 0
    return q, k, v, do, mask


def _plain_all(fa, q, k, v, do, mask, scale):
    o, lse = fa.flash_forward_plain(q, k, v, mask, scale)
    di = fa.row_dot(do, o)
    return (o, lse, fa.flash_bwd_dq_plain(q, k, v, mask, lse, di, do, scale),
            *fa.flash_bwd_dkv_plain(q, k, v, mask, lse, di, do, scale))


def _kernel_all(fa, q, k, v, do, mask, scale):
    o, lse = fa.flash_fwd_cuda(q, k, v, mask, scale)
    di = fa.row_dot(do, o)
    dq = fa.flash_bwd_dq_cuda(q, k, v, mask, lse, di, do, scale)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, mask, lse, di, do, scale)
    return o, lse, dq, dk, dv


def phase_kernels():
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    b, h, d = 2, 24, 128
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    names = ("o", "lse", "dq", "dk", "dv")
    errors = {}
    for case, s, masked in (("main", 1536, False), ("masked", 1536, True),
                            ("ragged", 1000, False)):
        q, k, v, do, mask = _attn_inputs(b, s, h, d, masked, gen)
        ref = _plain_all(fa, q.float(), k.float(), v.float(), do.float(), mask, scale)
        plain = _plain_all(fa, q, k, v, do, mask, scale)
        got = _kernel_all(fa, q, k, v, do, mask, scale)
        torch.cuda.synchronize()
        rec = {}
        for name, g, p, r in zip(names, got, plain, ref):
            check(g.shape == r.shape and bool(torch.isfinite(g).all()),
                  f"{case}/{name}: shape {tuple(g.shape)} or non-finite values")
            err = (g.float() - r).abs().max().item()
            plain_err = (p.float() - r).abs().max().item()
            floor = 1e-3 * r.abs().max().item()
            rec[name] = dict(err=err, plain_err=plain_err, floor=floor)
            check(err <= 2 * plain_err + floor,
                  f"{case}/{name}: kernel error {err} > 2 * {plain_err} + {floor}")
        if masked:
            # element 0's padded keys get no gradient
            check(bool((got[3][0, 300:512] == 0).all() and (got[4][0, 300:512] == 0).all()),
                  "masked keys received dK/dV")
        emit(phase="kernels", case=case, shape=[b, s, h, d], masked=masked, errors=rec)
        errors[case] = rec
        del ref, plain, got

    # timings at the main path's shape (unmasked, S = 512 text + 1024 image)
    s = 1536
    q, k, v, do, _ = _attn_inputs(b, s, h, d, False, gen)
    o, lse = fa.flash_fwd_cuda(q, k, v, None, scale)
    di = fa.row_dot(do, o)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    dot_ = do.transpose(1, 2).contiguous()
    timing = {
        "flash_fwd": dict(
            ms=cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, None, scale)),
            plain_ms=cuda_ms(lambda: fa.flash_forward_plain(q, k, v, None, scale), 5),
            library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach()))),
        "flash_bwd_dq": dict(
            ms=cuda_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, None, lse, di, do, scale)),
            plain_ms=cuda_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, None, lse, di, do, scale), 5),
            library_ms=None),
        "flash_bwd_dkv": dict(
            ms=cuda_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, None, lse, di, do, scale)),
            plain_ms=cuda_ms(lambda: fa.flash_bwd_dkv_plain(q, k, v, None, lse, di, do, scale), 5),
            library_ms=None),
    }
    # yardstick for K2 + K3 together: SDPA's backward (dQ, dK, dV in one call)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), dot_, retain_graph=True))

    n = b * s * h * d  # elements of one [B, S, H, D] tensor
    rows = b * h * s
    pair = b * h * s * s * d
    work = {  # flops, bytes (each input read once, each output written once)
        "flash_fwd": (4 * pair, 2 * 4 * n + 4 * rows),
        "flash_bwd_dq": (6 * pair, 2 * 5 * n + 2 * 4 * rows),
        "flash_bwd_dkv": (8 * pair, 2 * 6 * n + 2 * 4 * rows),
    }
    for name, (flops, nbytes) in work.items():
        t, by = bound(flops, nbytes)
        timing[name].update(bound_ms=t, bound_by=by, flops=flops, bytes=nbytes)
        err_keys = {"flash_fwd": ("o", "lse"), "flash_bwd_dq": ("dq",),
                    "flash_bwd_dkv": ("dk", "dv")}[name]
        timing[name]["max_abs_err"] = max(errors["main"][k]["err"] for k in err_keys)
    emit(phase="kernels", case="timing", shape=[b, s, h, d], timing=timing,
         sdpa_bwd_ms=sdpa_bwd_ms)
    return timing


# --- phase 3 ------------------------------------------------------------------


def _small_flux_run(model, latents_packed, t5, clip, t, img_ids, txt_ids, target):
    out = model(latents_packed, t5, clip, t, img_ids, txt_ids, guidance=torch.ones_like(t))
    loss = torch.mean((out.float() - target) ** 2)
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters() if p.requires_grad}
    return out.float().cpu(), loss.item(), grads


def phase_reference(device="cuda"):
    from diffusion_pipe_tpu_torch.models.flux import latent_image_ids, pack_latents
    from diffusion_pipe_tpu_torch.models.flux_model import FluxConfig, FluxTransformer
    from diffusion_pipe_tpu_torch.models.layers import init_module_weights
    from diffusion_pipe_tpu_torch.training.train_state import lora_predicate

    def build(dtype, device):
        cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=2,
                         joint_attention_dim=64, pooled_projection_dim=32,
                         dtype=dtype, param_dtype=dtype, lora_rank=4, lora_alpha=4.0,
                         lora_dtype=dtype, remat="full")
        with torch.device(device):
            m = FluxTransformer(cfg)
        for n, p in m.named_parameters():
            p.requires_grad_(lora_predicate(n))
        return m

    cpu = build(torch.float32, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    init_module_weights(cpu, gen)
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=gen)
    gpu = build(torch.bfloat16, device)
    gpu.load_state_dict(cpu.state_dict())

    # 16x16 latents -> 64 image tokens + 40 text tokens: 104, a ragged tile
    lat = torch.randn((1, 16, 16, 16), generator=gen)
    x = pack_latents(lat)
    t5 = torch.randn((1, 40, 64), generator=gen)
    clip = torch.randn((1, 32), generator=gen)
    t = torch.tensor([0.4])
    target = torch.randn(x.shape, generator=gen)
    img_ids = latent_image_ids(8, 8)
    txt_ids = torch.zeros((40, 3))
    ref_out, ref_loss, ref_grads = _small_flux_run(cpu, x, t5, clip, t, img_ids, txt_ids, target)
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_counts()
    to = lambda z, dt=torch.bfloat16: z.to(device, dt)
    out, loss, grads = _small_flux_run(
        gpu, to(x), to(t5), to(clip), to(t, torch.float32), to(img_ids, torch.float32),
        to(txt_ids, torch.float32), to(target, torch.float32))
    counts = fa.launch_counts()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    out_err = rel(out, ref_out)
    names = sorted(ref_grads)
    grad_err = rel(torch.cat([grads[n].flatten() for n in names]),
                   torch.cat([ref_grads[n].flatten() for n in names]))
    worst_grad_err = max(rel(grads[n], ref_grads[n]) for n in names)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    emit(phase="reference", out_rel_l2=out_err, loss_rel=loss_err,
         lora_grads_rel_l2=grad_err, worst_lora_tensor_rel_l2=worst_grad_err,
         launches=counts)
    check(all(c > 0 for c in counts.values()), f"reference run skipped a kernel: {counts}")
    # bf16 against f32 through two blocks: about 1% expected on the output,
    # the loss and the LoRA gradients taken together
    check(out_err < 3e-2 and loss_err < 3e-2 and grad_err < 5e-2,
          f"reference mismatch: out {out_err}, loss {loss_err}, grads {grad_err}")


# --- phase 4 ------------------------------------------------------------------

SLICE_CONFIG = {
    "save_every_n_epochs": 1,
    "model": {"type": "flux", "dtype": "bfloat16", "guidance": 1.0},
    "adapter": {"type": "lora", "rank": 32, "alpha": 32, "dropout": 0.0},
    "optimizer": {"type": "adamw8bit", "lr": 1e-4},
    "gradient_clipping": 1.0,
    "activation_checkpointing": True,
}


def _fingerprint(params):
    return torch.stack([p.detach().float().sum() for p in params]).double()


def build_slice(cfg=SLICE_CONFIG, device="cuda", latent_hw=64, txt_len=512,
                batch_size=2):
    """The main path's trainer, its state, step and batch: Flux at the config's
    width and depth, random weights and inputs from SEED."""
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
    from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
    from diffusion_pipe_tpu_torch.training.trainer import init_train_state, make_train_step

    pipeline = get_model_class("flux")(cfg, device=device)
    fc = pipeline.flux_config
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = init_train_state(pipeline, get_optimizer(cfg), gen, lora_predicate)
    step = make_train_step(pipeline, gradient_clipping=cfg["gradient_clipping"])
    batch = {
        "latents": torch.randn((batch_size, 16, latent_hw, latent_hw), generator=gen,
                               device=device),
        "t5_embed": torch.randn((batch_size, txt_len, fc.joint_attention_dim),
                                generator=gen, device=device).to(fc.dtype),
        "clip_embed": torch.randn((batch_size, fc.pooled_projection_dim), generator=gen,
                                  device=device).to(fc.dtype),
    }
    return pipeline, state, step, batch, gen


def phase_slice(**slice_kw):
    from diffusion_pipe_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    pipeline, state, step, batch, gen = build_slice(**slice_kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    fc = pipeline.flux_config
    model = pipeline.model
    n_params = sum(p.numel() for p in model.parameters())
    lora = list(state.trainable.values())
    frozen = [p for p in model.parameters() if not p.requires_grad]
    n_lora = sum(p.numel() for p in lora)
    lora0 = [p.detach().clone() for p in lora]
    frozen0 = _fingerprint(frozen)
    batch_size = batch["latents"].shape[0]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = step(state, batch, gen)
    warm_loss = warm["loss"].item()
    warm_s = time.perf_counter() - t0

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(state, batch, gen) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    counts = fa.launch_counts()
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    peak = torch.cuda.max_memory_allocated()

    per_step = {k: v / TIMED_STEPS for k, v in counts.items()}
    blocks = fc.num_layers + fc.num_single_layers
    expected = {"flash_fwd_cuda": 2 * blocks, "flash_bwd_dq_cuda": blocks,
                "flash_bwd_dkv_cuda": blocks}
    moved = sum(int(not torch.equal(p, p0)) for p, p0 in zip(lora, lora0))
    frozen_same = torch.equal(_fingerprint(frozen), frozen0)
    emit(phase="slice", params=n_params, lora_params=n_lora, init_s=init_s,
         warmup_s=warm_s, warmup_loss=warm_loss, step_s=step_s,
         samples_per_s=batch_size / step_s, losses=losses, grad_norms=norms,
         peak_memory_bytes=peak, launches=counts, launches_per_step=per_step,
         lora_tensors_moved=moved, lora_tensors=len(lora), frozen_unchanged=frozen_same)
    check(all(math.isfinite(x) for x in [warm_loss, *losses]), f"non-finite loss: {losses}")
    check(moved > 0, "no LoRA factor changed")
    check(frozen_same, "frozen weights changed")
    check(per_step == expected, f"launches per step {per_step}, expected {expected}")
    return counts


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "diffusion_pipe_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    phase_build()
    timing = phase_kernels()
    phase_reference()
    counts = phase_slice()

    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        tm = timing[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[f"{name}_cuda"], max_abs_err=tm["max_abs_err"],
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
            bound_by=tm["bound_by"], library_ms=tm["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
