"""Train-state checkpoints, save triggers and model/adapter export.

Counterpart of diffusion_pipe_tpu/training/saver.py, with the same run-dir
layout: `global_step{N}/` checkpoints with `client_state.json` (the step and
the dataloader position) and a `latest` file naming the newest, and
`epoch{N}/`, `step{N}/`, `examples{N}/` exports. The state goes into
`global_step{N}/state.pt` (torch.save; it loads with weights_only=True)
instead of an Orbax directory: the trainable tensors by name, the
optimizer's per-parameter state (adamw8bit's int8 moments and f32 scales,
adamw's moments, the step counts), the step and the examples seen. Frozen
weights are not saved; the hyperparameters come from the config on every
run. Triggers: save_every_n_epochs / steps / examples,
checkpoint_every_n_epochs / minutes, and the `save` / `save_quit` files
polled each step.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch


class Saver:
    def __init__(self, config: Dict[str, Any], run_dir, pipeline, dataloader=None):
        self.config = config
        self.run_dir = Path(run_dir)
        self.pipeline = pipeline
        self.dataloader = dataloader
        self.last_checkpoint_time = time.time()
        self.run_dir.mkdir(parents=True, exist_ok=True)

    # --- training-state checkpoints ----------------------------------------

    def _ckpt_dir(self, step: int) -> Path:
        return self.run_dir / f"global_step{step}"

    def save_checkpoint(self, state, step: int):
        path = self._ckpt_dir(step)
        path.mkdir(parents=True, exist_ok=True)
        params = list(state.trainable.values())
        torch.save({
            "trainable": {k: p.detach().cpu() for k, p in state.trainable.items()},
            "optimizer": [{k: v.detach().cpu() if torch.is_tensor(v) else v
                           for k, v in state.optimizer.state[p].items()} for p in params],
            "step": int(state.step),
            "examples": int(state.examples),
        }, path / "state.pt")
        meta = {"step": int(step)}
        if self.dataloader is not None:
            meta["custom_loader"] = self.dataloader.state_dict()
        (path / "client_state.json").write_text(json.dumps(meta))
        (self.run_dir / "latest").write_text(path.name)
        self.last_checkpoint_time = time.time()

    @torch.no_grad()
    def load_checkpoint(self, state, step: Optional[int] = None,
                        reset_optimizer: bool = False,
                        reset_optimizer_params: bool = False,
                        reset_dataloader: bool = False):
        """Restore into `state` (and its model) in place. Returns (state,
        client meta). reset_optimizer keeps the fresh optimizer state;
        reset_optimizer_params keeps the moments but restarts the LR
        schedule; reset_dataloader keeps the loader at its start."""
        if step is None:
            latest = self.run_dir / "latest"
            if not latest.exists():
                raise FileNotFoundError(f"no checkpoint in {self.run_dir}")
            path = self.run_dir / latest.read_text().strip()
        else:
            path = self._ckpt_dir(step)
        saved = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
        if set(saved["trainable"]) != set(state.trainable):
            raise ValueError(f"{path}: the checkpoint's trainable tensors differ from the model's")
        for name, p in state.trainable.items():
            p.copy_(saved["trainable"][name])
        if not reset_optimizer:
            # set directly: Optimizer.load_state_dict would cast every float
            # state tensor to its parameter's dtype (adamw8bit's f32 scales of
            # bf16 parameters, adamw's f32 moments)
            for p, st in zip(state.trainable.values(), saved["optimizer"]):
                st = {k: v.to(p.device) if torch.is_tensor(v) else v for k, v in st.items()}
                if reset_optimizer_params and st:
                    st["schedule_offset"] = st["step"]
                state.optimizer.state[p] = st
        state.step = saved["step"]
        state.examples = saved["examples"]
        meta = json.loads((path / "client_state.json").read_text())
        if self.dataloader is not None and not reset_dataloader and "custom_loader" in meta:
            self.dataloader.load_state_dict(meta["custom_loader"])
        return state, meta

    # --- model / adapter export --------------------------------------------

    def save_model(self, name: str, state):
        out_dir = self.run_dir / name
        out_dir.mkdir(parents=True, exist_ok=True)
        if "adapter" in self.config:
            self.pipeline.save_adapter(out_dir, state.trainable)
        else:
            self.pipeline.save_model(out_dir, self.pipeline.model)
        cfg_path = self.config.get("_config_path")
        if cfg_path and os.path.exists(cfg_path):
            shutil.copy(cfg_path, out_dir / "training_config.toml")

    # --- triggers -----------------------------------------------------------

    def _need_to_checkpoint(self, epoch_rollover=False, epoch=0) -> bool:
        c = self.config
        if epoch_rollover:
            return ("checkpoint_every_n_epochs" in c
                    and epoch % c["checkpoint_every_n_epochs"] == 0)
        if "checkpoint_every_n_minutes" in c:
            elapsed = (time.time() - self.last_checkpoint_time) / 60
            return elapsed >= c["checkpoint_every_n_minutes"]
        return False

    def process_epoch(self, state, epoch: int, step: int):
        """Call when the dataloader rolled into a new epoch. Returns the new
        epoch number, or None when config['epochs'] is exhausted."""
        if self._need_to_checkpoint(epoch_rollover=True, epoch=epoch):
            self.save_checkpoint(state, step)
        if "save_every_n_epochs" in self.config and epoch % self.config["save_every_n_epochs"] == 0:
            self.save_model(f"epoch{epoch}", state)
        new_epoch = epoch + 1
        if new_epoch > self.config.get("epochs", 10**9):
            return None
        return new_epoch

    def process_step(self, state, step: int, examples: int):
        """Per-step triggers and signal files. Returns True to quit."""
        should_save, should_quit = False, False
        save_f = self.run_dir / "save"
        quit_f = self.run_dir / "save_quit"
        if save_f.is_file():
            should_save = True
            save_f.unlink()
        elif quit_f.is_file():
            should_save = should_quit = True
            quit_f.unlink()

        c = self.config
        if "save_every_n_steps" in c and step % c["save_every_n_steps"] == 0:
            self.save_model(f"step{step}", state)
        if "save_every_n_examples" in c:
            per = c["save_every_n_examples"]
            if examples // per != getattr(self, "_last_examples_save", 0):
                self._last_examples_save = examples // per
                self.save_model(f"examples{examples}", state)
        if self._need_to_checkpoint() or should_save:
            self.save_checkpoint(state, step)
        return should_quit


def get_most_recent_run_dir(output_dir) -> str:
    runs = sorted(Path(output_dir).glob("*"))
    if not runs:
        raise FileNotFoundError(f"no runs in {output_dir}")
    return str(runs[-1])
