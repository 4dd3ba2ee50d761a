"""Metrics writer: an always-on JSONL mirror (run_dir/metrics.jsonl) plus
TensorBoard and wandb when they are installed, under the same tag names as
the JAX package's writer (train/loss, train/grad_norm, train/epoch_loss,
eval/<name>/loss_quantile_X, ...), the x axis switchable to examples.

The port's copy of diffusion_pipe_tpu/training/metrics.py.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsWriter:
    def __init__(self, run_dir, x_axis_examples: bool = False,
                 enable_tensorboard: bool = True, enable_wandb: bool = False,
                 wandb_config: Optional[Dict[str, Any]] = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.x_axis_examples = x_axis_examples
        self.jsonl = open(self.run_dir / "metrics.jsonl", "a")
        self.tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.run_dir))
            except ImportError:
                pass
        self.wandb = None
        if enable_wandb:
            try:
                import wandb

                wandb.init(**(wandb_config or {}))
                self.wandb = wandb
            except ImportError:
                print("wandb not available; skipping")

    def write(self, metrics: Dict[str, float], step: int, examples: int = 0):
        x = examples if self.x_axis_examples else step
        rec = {"step": int(step), "examples": int(examples),
               "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), x)
        if self.wandb is not None:
            self.wandb.log(metrics, step=x)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
