#!/usr/bin/env python3
"""Runs chip_smoke.py phases of another tree and of this one in turns on one
GPU: parent, change, change, parent, each tree's run after the --before
phases (if any) in the same process. Without --parent, runs this tree's
phases alone and after the --before phases, in turns: alone, after, after,
alone (what the phases before it in the smoke leave behind).

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/compare_smoke_phases.py --parent build/parent \
        --phases slice-wan-lora driver-wan
    python3 tools/compare_smoke_phases.py --phases driver-wan \
        --before slice-flux-lokr sample
    python3 tools/compare_smoke_phases.py --parent build/parent \
        --phases clip-vision driver-wan --before vae driver

Each run is a process of its own started in the tree's root, which builds
that tree's kernels into its own build/ directory and runs the phases with
that tree's chip_smoke.py (TF32 off, as the smoke runs). Phases:
  slice-wan-lora -- bench.py's Wan row, one warm-up and five timed steps;
  driver-wan     -- the Wan row through the training driver, after the
                    wan-vae phase that writes the VAE weights it caches with;
                    a tree whose phase_driver_wan takes `extras` runs it with
                    extras=False (no --test_sample, no --dump_dataset), so
                    both trees run the same calls;
  wan-lora-1k    -- the Wan row's trainer alone at the driver's shape (one
                    512 px frame, 1,024 tokens, 512 text tokens), built by
                    the tree's build_wan_slice: two warm-up steps, ten timed
                    (each ended by a synchronize; step_s is their median),
                    then three steps under torch.profiler: host operator
                    calls, kernel launches and device-busy ms a step, and the
                    host operators with the most self time;
  slice-flux-lokr, sample -- those smoke phases (this tree's only);
  slice-auraflow-lora -- AuraFlow v0.3 at full size (D 256 attention), one
                    warm-up and two timed steps;
  vae, driver, clip-vision -- those smoke phases (driver after vae).
Every JSON line a phase prints is printed again with "tree" and "turn"
added, after a "process-state" line taken just before the phases (the
objects the garbage collector tracks, the host's resident bytes and OS
threads, the CPU seconds the process spends in one second of sleep, the
card's allocated and reserved bytes); a summary line gives each phase's
main time by tree and turn, and the card's name and power limit come
first.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PHASES = {  # name: (code run in the tree's chip_smoke, JSON key of its time)
    "slice-wan-lora": ('cs.phase_slice_wan(phase="slice-wan-lora", cell="wan-1.3b-t2v-lora-attn", '
                       'cfg=cs.WAN_LORA_CONFIG, timed_steps=cs.TIMED_STEPS)', "step_s"),
    "driver-wan": ('cs.phase_driver_wan(cs.phase_wan_vae(), **({"extras": False} if "extras" in '
                   'inspect.signature(cs.phase_driver_wan).parameters else {}))', "step_s"),
    "wan-lora-1k": ("wan_lora_1k()", "step_s"),
    "slice-flux-lokr": ('cs.phase_slice(phase="slice-flux-lokr", cell="flux-dev-lokr-512-fp8-int8", '
                        'cfg=cs.LOKR_CONFIG, every_moved=True); cs._free()', "step_s"),
    "sample": ("cs.phase_sample()", "flux_512_s"),
    "slice-auraflow-lora": ("cs.phase_slice_auraflow()", "step_s"),
    "vae": ("vae_dir = cs.phase_vae(); cs._free()", None),
    "driver": ("cs.phase_driver(vae_dir, 0.0); cs._free()", "step_s"),
    "clip-vision": ("cs.phase_clip_vision(); cs._free()", "encode_ms"),
}

RUNNER = """
import inspect
import json
import sys
import time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build()


def wan_lora_1k(timed=10, profiled=3):
    from torch.autograd import DeviceType
    pipeline, state, step, batch, gen = cs.build_wan_slice(cfg=cs.WAN_LORA_CONFIG,
                                                           latent_fhw=(1, 64, 64))
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(profiled):
            step(state, batch, gen)
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    host = [e for e in events if e.device_type == DeviceType.CPU]
    ops = sum(e.name.startswith("aten::") for e in host)
    launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                              "cuLaunchKernelEx") for e in host)
    avg = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    times.sort()
    print(json.dumps(dict(
        phase="wan-lora-1k", tokens_per_sample=1024, step_s=times[len(times) // 2],
        step_times_s=times, host_ops_per_step=ops / profiled,
        launches_per_step=launches / profiled, device_busy_ms_per_step=busy / 1e3 / profiled,
        top_self_cpu_ms_per_step=[(e.key, e.self_cpu_time_total / 1e3 / profiled, e.count // profiled)
                                  for e in avg])), flush=True)
    del pipeline, state, step, batch
    cs._free()


def process_state():
    import gc
    status = dict(line.split(":", 1) for line in open("/proc/self/status"))
    cs._free()
    cpu0 = time.process_time()
    time.sleep(1.0)
    print(json.dumps(dict(phase="process-state", gc_objects=len(gc.get_objects()),
                          host_rss_bytes=int(status["VmRSS"].split()[0]) * 1024,
                          os_threads=int(status["Threads"]),
                          cpu_s_in_1s_sleep=time.process_time() - cpu0,
                          cuda_allocated_bytes=torch.cuda.memory_allocated(),
                          cuda_reserved_bytes=torch.cuda.memory_reserved())), flush=True)


{before}
process_state()
{calls}
"""


def run(tree: Path, phases, before=()):
    code = RUNNER.format(before="\n".join(PHASES[p][0] for p in before),
                         calls="\n".join(PHASES[p][0] for p in phases))
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"the phases failed in {tree}")
    lines = []
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("phase") in phases or rec.get("phase") == "process-state":
                lines.append(rec)
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--phases", nargs="+", choices=sorted(PHASES), required=True)
    ap.add_argument("--before", nargs="+", choices=sorted(PHASES), default=[])
    args = ap.parse_args()
    if args.parent is None and not args.before:
        ap.error("give --parent, --before or both")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if args.parent is not None:
        parent, before = args.parent.resolve(), args.before
        turns = [("parent", parent, before), ("change", ROOT, before),
                 ("change", ROOT, before), ("parent", parent, before)]
    else:
        turns = [("alone", ROOT, ()), ("after", ROOT, args.before),
                 ("after", ROOT, args.before), ("alone", ROOT, ())]
    summary = {p: {name: [] for name, *_ in turns[:2]} for p in args.phases}
    for turn, (name, path, before) in enumerate(turns):
        for rec in run(path, args.phases, before):
            if rec["phase"] in summary and PHASES[rec["phase"]][1] in rec:
                summary[rec["phase"]][name].append(rec[PHASES[rec["phase"]][1]])
            print(json.dumps({"tree": name, "turn": turn, **rec}), flush=True)
    print(json.dumps({"summary": summary, "card": card}))


if __name__ == "__main__":
    main()
