"""Per-model pipeline contract, counterpart of diffusion_pipe_tpu/models/base.py.

A pipeline owns its nn.Module on one device and adapts it to the trainer:

  init_params(generator)                 random init of every weight, in place
  prepare_inputs(batch, generator, ...)  -> (model_inputs, target, mask)
  forward(model_inputs)                  -> model output
  loss_fn(output, target, mask)          -> scalar f32 loss

and to the training driver (train.py) and the data pipeline:

  trainable_predicate()          -> predicate(name, param) of what trains
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

    def trainable_predicate(self):
        """predicate(name, param) -> whether the parameter trains: the
        adapter factors under `[adapter]`, else every parameter."""
        from ..training.train_state import predicate_from_config

        return predicate_from_config(self.config)

    def load_weights(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError(f"{self.name}: loading pretrained weights is not ported yet")

    def get_call_vae_fn(self):
        raise NotImplementedError(f"{self.name}: latent caching is not ported yet")

    def get_call_text_encoder_fns(self):
        raise NotImplementedError(f"{self.name}: text-embedding caching is not ported yet")

    def _load_generic_image_vae(self, tiny_latent_channels: int = 4, tiny_downscale: int = 2):
        """The AutoencoderKL-family VAE of the JAX
        BasePipeline._generic_image_vae_fn, loaded at the first call, in
        [model]'s dtype on the pipeline's device, frozen, as a
        NormalizedImageVAE: under `_tiny` a seeded small KL VAE at
        tiny_latent_channels, tiny_downscale x smaller than the pixels; else
        model.vae_path (alias `vae`) through load_image_vae, its topology
        from the shapes."""
        if getattr(self, "_vae", None) is None:
            from ..common import dtype_from_string
            from .autoencoder_kl import AutoencoderKL, VAEConfig, load_image_vae

            mc = self.model_config
            dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
            if mc.get("_tiny", False):
                blocks = (8,) + (16,) * (tiny_downscale.bit_length() - 1)
                vae = AutoencoderKL(VAEConfig.tiny(latent_channels=tiny_latent_channels,
                                                   block_out_channels=blocks))
                vae = vae.to(self.device)
                vae.init_weights(torch.Generator(device=self.device).manual_seed(0))
                vae = vae.eval().requires_grad_(False)
                vae.latent_bn = None
            else:
                path = mc.get("vae_path") or mc.get("vae")
                if not path:
                    raise FileNotFoundError(f"{self.name}: set model.vae_path for latent caching")
                vae, _ = load_image_vae(path, device=self.device, dtype=dtype)
            self._vae = NormalizedImageVAE(vae)
        return self._vae

    def _generic_image_vae_fn(self, tiny_latent_channels: int = 4, tiny_downscale: int = 2):
        """get_call_vae_fn of the AutoencoderKL families:
        fn(pixels [B, 3, H, W] or [B, 3, 1, H, W] in [-1, 1], numpy) ->
        {"latents": [B, C, H/8, W/8] f32 CPU tensor}, through
        _load_generic_image_vae."""

        def fn(pixels):
            import numpy as np

            vae = self._load_generic_image_vae(tiny_latent_channels, tiny_downscale)
            x = torch.from_numpy(np.asarray(pixels, np.float32))
            if x.dim() == 5:
                x = x[:, :, 0]
            with torch.no_grad():
                return {"latents": vae.encode(x.to(self.device)).float().cpu()}

        return fn

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


class NormalizedImageVAE:
    """An AutoencoderKL whose latents are normalised, where the VAE carries
    batch-norm statistics of its 2 x 2-packed latents (FLUX.2's
    `bn.running_mean` / `running_var`, vae.latent_bn): encode gives (z -
    mean) / sqrt(var + eps) per packed channel, stored unpacked; decode
    inverts it. Without statistics both pass through."""

    def __init__(self, vae):
        self.vae = vae

    def _stats(self, z):
        """Per-pixel [C, h, w] mean and std of the unpacked latents z: packed
        channel c * 4 + 2 dy + dx (pack_latents' order) tiled over the 2 x 2
        patches."""
        mean, var, eps = self.vae.latent_bn
        c, h, w = mean.shape[0] // 4, z.shape[-2], z.shape[-1]

        def tile(x):
            return x.float().reshape(c, 2, 2).repeat(1, h // 2, w // 2)

        return tile(mean), torch.sqrt(tile(var) + eps)

    def encode(self, pixels):
        z = self.vae.encode(pixels)
        if self.vae.latent_bn is None:
            return z
        mean, std = self._stats(z)
        return (z.float() - mean) / std

    def decode(self, z):
        if self.vae.latent_bn is not None:
            mean, std = self._stats(z)
            z = z.float() * std + mean
        return self.vae.decode(z)
