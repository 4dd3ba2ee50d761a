"""Per-model pipeline contract, counterpart of diffusion_pipe_tpu/models/base.py.

A pipeline owns its nn.Module on one device and adapts it to the trainer:

  init_params(generator)                 random init of every weight, in place
  prepare_inputs(batch, generator, ...)  -> (model_inputs, target, mask)
  forward(model_inputs)                  -> model output
  loss_fn(output, target, mask)          -> scalar f32 loss

and to the training driver (train.py) and the data pipeline:

  load_weights()                 -> state dict of pretrained weights
  get_call_vae_fn()              -> fn(pixels) -> {"latents": ...}
  get_call_text_encoder_fns()    -> [fn(captions) -> {name: embeddings}]
  save_adapter(dir, trainable) / load_adapter(path) -> adapter state dict
  save_model(dir, model)         (full fine-tuning export)

A family that defines keymap() (models/keymaps.py) gets the last three from
it; the others define their own or raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..common import resolve_device
from ..training.losses import loss_config_from_model_config, masked_loss


class BasePipeline:
    name: str = "base"
    framerate: Optional[float] = None  # video families set it
    # True for families whose text encoders run in the step (captions go
    # through the loader)
    pass_captions_to_batch: bool = False

    def __init__(self, config: Dict[str, Any], device: Optional[torch.device] = None):
        self.config = config
        self.model_config = config["model"]
        self.device = resolve_device(device)
        self._loss_kwargs = loss_config_from_model_config(self.model_config)

    def init_params(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise=None, t=None):
        raise NotImplementedError

    def forward(self, model_inputs: Dict[str, Any]):
        raise NotImplementedError

    def loss_fn(self, output, target, mask):
        """Default masked loss in f32."""
        return masked_loss(output, target, mask, **self._loss_kwargs)

    def host_prepare(self, batch):
        """Host-side batch transform before the step (e.g. tokenization)."""
        return batch

    def lr_scale_map(self, base_lr) -> Dict[str, float]:
        """Per-module LR multipliers by parameter-name substring."""
        return {}

    def load_weights(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError(f"{self.name}: loading pretrained weights is not ported yet")

    def get_call_vae_fn(self):
        raise NotImplementedError(f"{self.name}: latent caching is not ported yet")

    def get_call_text_encoder_fns(self):
        raise NotImplementedError(f"{self.name}: text-embedding caching is not ported yet")

    # --- weight-key map (drives load / save when defined) ---------------------

    def keymap(self):
        """The family's models/keymaps.py KeyMap, or None. With one, the
        generic save_adapter / load_adapter / save_model below work."""
        return None

    def _keymap_config(self):
        """The config object whose attributes hold the block counts."""
        raise NotImplementedError

    def _require_keymap(self, what: str):
        km = self.keymap()
        if km is None:
            raise NotImplementedError(f"{self.name}: {what} is not ported yet")
        return km

    def save_adapter(self, out_dir, trainable) -> None:
        """The adapter factors in the keymap's LoRA dialect
        (adapter_model.safetensors), with `.alpha` entries (see
        keymaps.save_lora_safetensors)."""
        from .keymaps import export_lora_keymap, save_lora_safetensors

        km = self._require_keymap("adapter export")
        sd = export_lora_keymap(trainable, km, self._keymap_config())
        if not sd:
            raise RuntimeError("no adapter factors found to export")
        adapter = self.config.get("adapter", {})
        save_lora_safetensors(out_dir, sd, alpha=adapter.get("alpha"), rank=adapter.get("rank"))
        print(f"saved {len(sd)} adapter tensors to {out_dir}")

    def load_adapter(self, path) -> Dict[str, torch.Tensor]:
        """adapter.init_from_existing: the factors of a saved adapter as a
        partial state dict to load over the initialised model."""
        from .keymaps import import_lora_keymap

        km = self._require_keymap("adapter.init_from_existing")
        return import_lora_keymap(path, km, self._keymap_config())

    def save_model(self, out_dir, model) -> None:
        """A fully fine-tuned model as out_dir/model.safetensors in the
        keymap's checkpoint layout (metadata format = pt), with the
        passthrough tensors kept at load, cast to save_dtype when set."""
        from pathlib import Path

        from .. import safetensors_io
        from ..common import dtype_from_string
        from .keymaps import keymap_from_state_dict

        km = self._require_keymap(
            "saving a fully fine-tuned model (its models/keymaps.py KeyMap)")
        sd = keymap_from_state_dict(model.state_dict(), km, self._keymap_config())
        for k, v in getattr(self, "_passthrough_sd", {}).items():
            sd.setdefault(k, v)
        if "save_dtype" in self.config:
            dt = dtype_from_string(self.config["save_dtype"])
            sd = {k: v.to(dt) for k, v in sd.items()}
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        safetensors_io.save_file({k: v.detach().contiguous().cpu() for k, v in sd.items()},
                                 str(out / "model.safetensors"), metadata={"format": "pt"})
        print(f"saved {len(sd)} tensors to {out / 'model.safetensors'}")
