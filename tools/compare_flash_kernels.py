#!/usr/bin/env python3
"""Times this tree's flash-attention kernels K1 (forward), K2 (dQ) and K3
(dK/dV) against another tree's, in one process on one GPU.

    git archive <commit> diffusion_pipe_tpu_torch | tar -x -C build/parent
    python3 tools/compare_flash_kernels.py --parent build/parent
    python3 tools/compare_flash_kernels.py --parent build/parent --shapes auraflow

The other tree's package is loaded under the name `dpt_parent` and builds
its kernels into its own build/ directory. At each shape (bf16; by default
the D 128 shapes of the port's main paths: Flux-dev B 2, H 24, S 1536;
Wan2.1 cross-attention Sq 21504, Skv 512, H 12; Wan2.1 self-attention
S 21504, H 12; or those --shapes names, AuraFlow's B 2, S 4360, H 12 at
D 256 and SD3's B 2, S 4429, H 24 at D 64 among them) it checks
that the two trees' outputs agree (max abs difference, printed), then times
each kernel in turns, parent, change, change, parent, with CUDA events over
a run of launches after a warm-up. One JSON line a shape and kernel, then a
summary line; each time is in ms, beside the card's name and power limit.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = {  # name: (B, Sq, Skv, H, D)
    "flux": (2, 1536, 1536, 24, 128),
    "wan_cross": (1, 21504, 512, 12, 128),
    "wan_self": (1, 21504, 21504, 12, 128),
    "auraflow": (2, 4360, 4360, 12, 256),
    "sd3_d64": (2, 4429, 4429, 24, 64),
}
DEFAULT_SHAPES = ("flux", "wan_cross", "wan_self")


def load_parent(parent: Path):
    pkg = parent / "diffusion_pipe_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "dpt_parent", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["dpt_parent"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("dpt_parent.ops.flash_attention"),
            importlib.import_module("dpt_parent.ops.kernel_build"))


def cuda_ms(fn, iters):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the other tree (holds diffusion_pipe_tpu_torch/)")
    ap.add_argument("--shapes", nargs="+", choices=sorted(SHAPES), default=DEFAULT_SHAPES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_flash_kernels: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    from diffusion_pipe_tpu_torch.ops import flash_attention as new_fa
    from diffusion_pipe_tpu_torch.ops import kernel_build as new_kb

    old_fa, old_kb = load_parent(args.parent.resolve())
    for kb in (old_kb, new_kb):
        kb.build_all()

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for shape in args.shapes:
        b, sq, skv, h, d = SHAPES[shape]
        q, do = (torch.randn((b, sq, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, skv, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        scale = d ** -0.5
        o, lse = new_fa.flash_fwd_cuda(q, k, v, None, scale)
        di = new_fa.row_dot(do, o)
        calls = {
            "flash_fwd": {fa: (lambda fa=fa: fa.flash_fwd_cuda(q, k, v, None, scale))
                          for fa in (old_fa, new_fa)},
            "flash_bwd_dq": {fa: (lambda fa=fa: (fa.flash_bwd_dq_cuda(
                q, k, v, None, lse, di, do, scale),)) for fa in (old_fa, new_fa)},
            "flash_bwd_dkv": {fa: (lambda fa=fa: fa.flash_bwd_dkv_cuda(
                q, k, v, None, lse, di, do, scale)) for fa in (old_fa, new_fa)},
        }
        iters = 5 if shape == "wan_self" else 20
        for name, fns in calls.items():
            got_old, got_new = fns[old_fa](), fns[new_fa]()
            torch.cuda.synchronize()
            diff = max((x.float() - y.float()).abs().max().item()
                       for x, y in zip(got_old, got_new))
            del got_old, got_new
            order = (old_fa, new_fa, new_fa, old_fa)
            times = [cuda_ms(fns[fa], iters) for fa in order]
            rec = dict(shape=shape, kernel=name, q_shape=[b, sq, h, d], kv_len=skv,
                       parent_ms=[times[0], times[3]], change_ms=[times[1], times[2]],
                       parent_mean_ms=(times[0] + times[3]) / 2,
                       change_mean_ms=(times[1] + times[2]) / 2,
                       max_abs_diff=diff, iters=iters, card=card)
            rec["speedup"] = rec["parent_mean_ms"] / rec["change_mean_ms"]
            print(json.dumps(rec), flush=True)
            summary[f"{name}/{shape}"] = [rec["parent_mean_ms"], rec["change_mean_ms"]]
        del q, k, v, do, o, lse, di
        torch.cuda.empty_cache()
    print(json.dumps({"summary_parent_vs_change_ms": summary, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
