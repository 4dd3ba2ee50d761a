#!/usr/bin/env python3
"""torch._int_mm on the card: which shapes it takes, which layouts are fast.

    python3 tools/int_mm_layouts.py

Prints one JSON line per case, then the card's name and power limit:

- rows 2, 16 and 17 against the Flux adaLN linear's [3072, 18432]: CUDA's
  torch._int_mm refuses 16 rows or fewer (ops/int8_quant.int_mm pads them);
- at three Flux block shapes, [rows, in] x [in, out]: the product with the
  second operand as the transposed view of the stored [out, in] weight (the
  forward's layout, K-major), as a row-major [in, out] tensor, and the
  int8 dgrad's product [rows, out] x [out, in] with the weight as stored
  (row-major, not K-major) and through a transposed copy; beside them
  torch.matmul in bf16 on the same shapes. Each product is checked against
  the CPU's torch._int_mm.
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = {"ff_in": (2048, 3072, 12288), "single_proj_out": (3072, 15360, 3072),
          "norm1_linear_padded": (32, 3072, 18432)}


def ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        print("int_mm_layouts: CUDA is not available", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)

    def ints(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    w = ints((18432, 3072))
    for rows in (2, 16, 17):
        rec = dict(case="rows", rows=rows)
        try:
            torch._int_mm(ints((rows, 3072)), w.t())
            torch.cuda.synchronize()
            rec["accepted"] = True
        except RuntimeError as ex:
            rec.update(accepted=False, error=str(ex).splitlines()[0][:160])
        print(json.dumps(rec), flush=True)

    for name, (m, k, n) in SHAPES.items():
        x, w, g = ints((m, k)), ints((n, k)), ints((m, n))
        w_rows = w.t().contiguous()  # [in, out] row-major
        cases = {
            "forward_kmajor": (lambda: torch._int_mm(x, w.t()), x, w.t()),
            "forward_rowmajor": (lambda: torch._int_mm(x, w_rows), x, w_rows),
            "dgrad_as_stored": (lambda: torch._int_mm(g, w), g, w),
            "dgrad_transposed_copy": (lambda: torch._int_mm(g, w.t().contiguous().t()), g, w),
        }
        rec = dict(case=name, shape=[m, k, n])
        for label, (fn, a, b) in cases.items():
            ok = torch.equal(fn().cpu(), torch._int_mm(a.cpu(), b.cpu()))
            rec[label] = dict(ms=ms(fn), exact=ok)
        xb, wb, gb = x.bfloat16(), w.bfloat16(), g.bfloat16()
        rec["bf16_forward_ms"] = ms(lambda: torch.matmul(xb, wb.t()))
        rec["bf16_dgrad_ms"] = ms(lambda: torch.matmul(gb, wb))
        rec["transpose_copy_ms"] = ms(lambda: w.t().contiguous())
        print(json.dumps(rec), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), nvidia_smi=card,
                          torch=torch.__version__)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
