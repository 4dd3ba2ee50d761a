"""SDXL pipeline: DDPM eps / v-prediction training with the CLIP text towers
in the step.

Counterpart of diffusion_pipe_tpu/models/sdxl.py:
- the model is SDXLModel: the UNet and both towers in one module, under
  `unet.`, `text_encoder.` (CLIP-L) and `text_encoder_2.` (OpenCLIP bigG);
  under LoRA the towers are frozen, under full fine-tuning they train, with
  the unet_lr / text_encoder_1_lr / text_encoder_2_lr groups of
  lr_scale_map;
- no text embeddings are cached: captions ride in the batch and
  host_prepare tokenizes them into 75-token chunks [BOS, ..., EOS, PAD...]
  ([B, chunks, 77] ids; the `_tiny` hook takes character codes). The
  towers encode the chunks folded into the batch and re-join them along
  the sequence; the context is the two penultimate hidden states (or
  -(clip_skip + 2)) concatenated, the pooled embedding bigG's of the first
  chunk;
- prepare_inputs: integer timesteps (uniform, or int(quantile * T) for the
  eval), DDPM add_noise, an eps or v target, add_time_ids [h, w, 0, 0, h,
  w] of the pixel size, a loss mask resized to the latents by nearest
  neighbour. The noise and t come from a torch.Generator, or are passed in;
- loss_fn: the per-example mean squared error times the min-SNR-gamma /
  debiased-estimation weight, averaged;
- sample: DDIM (eta 0) on diffusers' float64-rounded timestep grid, with
  classifier-free guidance;
- load_weights (a diffusers folder or an original-SD single file, with
  model.merge_adapters), save_adapter (kohya keys) and save_model (the SD
  single file: model.diffusion_model., conditioner.embedders.{0,1}. and the
  VAE as first_stage_model.), the SDXL VAE for the caching phase.
The `_random_te` hook gives full-size CLIP-L and bigG towers from a seed
(benchmarks without checkpoint files). Not ported: the pipeline-parallel
program (sdxl_pp.py, ROADMAP A11).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..common import dtype_from_string
from ..training.ddpm import DDPMSchedule, snr_loss_weight
from . import register_model
from .base import BasePipeline
from .clip_text import CLIPTextConfig, CLIPTextModel
from .flux import resize_mask_to_latents
from .layers import adapter_kwargs, init_module_weights, remat_spec
from .sdxl_unet import SDXLConfig, SDXLUNet


class SDXLModel(nn.Module):
    """The trained module: UNet and both CLIP text towers."""

    def __init__(self, unet: SDXLConfig, te1: CLIPTextConfig, te2: CLIPTextConfig):
        super().__init__()
        self.unet = SDXLUNet(unet)
        self.text_encoder = CLIPTextModel(te1)
        self.text_encoder_2 = CLIPTextModel(te2)


@register_model("sdxl")
class SDXLPipeline(BasePipeline):
    name = "sdxl"
    cacheable_text_embeddings = ()
    pass_captions_to_batch = True

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if config.get("blocks_to_swap"):
            raise NotImplementedError("blocks_to_swap is not ported yet (ROADMAP A10)")
        mc = self.model_config
        self.v_pred = bool(mc.get("v_pred", False))
        self.min_snr_gamma = mc.get("min_snr_gamma")
        self.debiased_estimation_loss = bool(mc.get("debiased_estimation_loss", False))
        self.schedule = DDPMSchedule.sdxl(v_pred=self.v_pred,
                                          zero_terminal_snr=bool(mc.get("zero_terminal_snr", False)))
        self.unet_config = self._build_unet_config()
        with torch.device("meta"):
            self.model = SDXLModel(self.unet_config, *self._text_encoder_configs())
        self._tokenizer = None

    def _build_unet_config(self) -> SDXLConfig:
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype, remat=remat_spec(self.config))
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        if mc.get("_tiny", False):
            return SDXLConfig.tiny(**kwargs)
        return SDXLConfig(**kwargs)

    def _text_encoder_configs(self):
        """CLIP-L and bigG: the `_tiny` hook's towers (both quick_gelu, as
        the JAX hook's), full size under `_random_te`, else the
        config.json of diffusers_path/text_encoder and text_encoder_2. f32,
        as the JAX package's Flax towers."""
        mc = self.model_config
        if mc.get("_tiny", False):
            return CLIPTextConfig.tiny(), CLIPTextConfig.tiny(with_projection=True)
        if mc.get("_random_te", False):
            return CLIPTextConfig.clip_l(), CLIPTextConfig.open_clip_bigg()
        base = Path(mc["diffusers_path"])
        return tuple(CLIPTextConfig.from_json(json.loads((base / sub / "config.json").read_text()),
                                              with_projection=proj)
                     for sub, proj in (("text_encoder", False), ("text_encoder_2", True)))

    def init_params(self, generator: torch.Generator) -> None:
        """Allocate every weight on the pipeline's device and fill it as the
        JAX package initialises the UNet (lecun-normal kernels, zero biases,
        norm scales one, LoRA A uniform and B zero) and the towers from the
        same generator."""
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    # --- captions -------------------------------------------------------------

    def _tokenize(self, captions) -> torch.Tensor:
        """captions -> int32 [B, chunks, 77]: one tokenizer for both towers,
        no truncation, 75-token chunks each laid out [BOS, ..., EOS, PAD...]
        (the chunk count the longest caption's); the `_tiny` hook's
        character codes (mod 256) in one chunk."""
        mc = self.model_config
        if mc.get("_tiny", False):
            ids = np.zeros((len(captions), 1, 77), np.int32)
            for i, c in enumerate(captions):
                for j, ch in enumerate(str(c)[:77]):
                    ids[i, 0, j] = ord(ch) % 256
            return torch.from_numpy(ids)
        if self._tokenizer is None:
            from transformers import AutoTokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(str(Path(mc["diffusers_path"])
                                                                / "tokenizer"))
        tok = self._tokenizer
        bos, eos, pad = tok.bos_token_id, tok.eos_token_id, tok.pad_token_id
        pad = eos if pad is None else pad
        encoded = [tok(str(c), truncation=False, add_special_tokens=False).input_ids
                   for c in captions]
        n_chunks = max(1, max((len(e) + 74) // 75 for e in encoded))
        out = np.full((len(captions), n_chunks, 77), pad, np.int32)
        out[:, :, 0] = bos
        for i, e in enumerate(encoded):
            for c in range(n_chunks):
                chunk = e[c * 75:(c + 1) * 75]
                out[i, c, 1:1 + len(chunk)] = chunk
                out[i, c, 1 + len(chunk)] = eos
        return torch.from_numpy(out)

    def host_prepare(self, batch):
        """Captions -> input_ids (and the same ids as input_ids_2)."""
        if "caption" in batch:
            ids = self._tokenize(list(batch["caption"]))
            batch = {k: v for k, v in batch.items() if k != "caption"}
            batch["input_ids"] = ids
            batch["input_ids_2"] = ids
        return batch

    def lr_scale_map(self, base_lr) -> Dict[str, float]:
        """unet_lr / text_encoder_1_lr / text_encoder_2_lr as factors of the
        base LR, keyed by slash-anchored path prefixes, so `text_encoder/`
        never matches a text_encoder_2 parameter."""
        mc = self.model_config
        out = {}
        for key, prefix in (("unet_lr", "unet/"), ("text_encoder_1_lr", "text_encoder/"),
                            ("text_encoder_2_lr", "text_encoder_2/")):
            if mc.get(key) is not None:
                out[prefix] = float(mc[key]) / base_lr
        return out

    # --- training inputs ------------------------------------------------------

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None,
                       t: Optional[torch.Tensor] = None):
        """batch: latents [B, 4, h, w], input_ids / input_ids_2 [B, chunks,
        77], optional mask [B, Hm, Wm]. t [B] (integers) and noise are drawn
        from `generator` unless given."""
        latents = batch["latents"].to(self.device, torch.float32)
        b, _, h, w = latents.shape
        mask = batch.get("mask")
        if mask is not None:
            mask = resize_mask_to_latents(mask.to(self.device), h, w, 1)
        if t is None:
            t = self.schedule.sample_timesteps(b, generator, timestep_quantile, device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=self.device)
        t = t.to(self.device, torch.int32)
        noise = noise.to(self.device, torch.float32)
        noisy = self.schedule.add_noise(latents, noise, t)
        target = self.schedule.get_velocity(latents, noise, t) if self.v_pred else noise
        ph, pw = h * 8, w * 8
        add_time_ids = torch.tensor([[ph, pw, 0, 0, ph, pw]], dtype=torch.float32,
                                    device=self.device).expand(b, 6)
        model_inputs = dict(sample=noisy, timesteps=t,
                            input_ids=batch["input_ids"].to(self.device),
                            input_ids_2=batch["input_ids_2"].to(self.device),
                            add_time_ids=add_time_ids)
        return model_inputs, target, mask

    def encode_text(self, ids1: torch.Tensor, ids2: torch.Tensor):
        """(context [B, 77 * chunks, 768 + 1280], pooled [B, 1280]) from
        token ids [B, chunks, 77] (or [B, 77])."""
        clip_skip = self.model_config.get("clip_skip")
        layer = -2 if clip_skip is None else -(int(clip_skip) + 2)

        def run(tower, ids):
            b, c, s = ids.shape
            hidden, pooled = tower(ids.reshape(b * c, s))
            return hidden[layer].reshape(b, c * s, -1), pooled.reshape(b, c, -1)[:, 0]

        if ids1.dim() == 2:
            ids1, ids2 = ids1[:, None], ids2[:, None]
        h1, _ = run(self.model.text_encoder, ids1)
        h2, pooled = run(self.model.text_encoder_2, ids2)
        return torch.cat([h1, h2], dim=-1), pooled

    def forward(self, model_inputs):
        """(prediction [B, 4, h, w] in the UNet's dtype, timesteps)."""
        ctx, pooled = self.encode_text(model_inputs["input_ids"], model_inputs["input_ids_2"])
        pred = self.model.unet(model_inputs["sample"], model_inputs["timesteps"], ctx, pooled,
                               model_inputs["add_time_ids"])
        return pred, model_inputs["timesteps"]

    def loss_fn(self, output, target, mask):
        pred, timesteps = output
        loss = (pred.float() - target.float()) ** 2
        if mask is not None and mask.numel() > 0:
            loss = loss * mask.float().expand_as(loss)
        loss = loss.mean(dim=(1, 2, 3))
        w = snr_loss_weight(self.schedule, timesteps, self.min_snr_gamma,
                            self.debiased_estimation_loss, self.v_pred)
        return (loss * w).mean()

    # --- sampling -------------------------------------------------------------

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 30,
               guidance_scale: float = 1.0, caption: str = "", negative_caption: str = "",
               noise: Optional[torch.Tensor] = None, **_unused):
        """DDIM (eta 0) through the training forward: latents [1, 4,
        height/8, width/8] f32 from `noise` or the generator's N(0, 1), on
        the timesteps linspace(T - 1, 0, num_steps) rounded in float64;
        with guidance_scale != 1 the negative caption's prediction guides
        eps and x0 is recomputed from it."""
        ids = self._tokenize([caption]).to(self.device)
        ctx, pooled = self.encode_text(ids, ids)
        if guidance_scale != 1.0:
            un_ids = self._tokenize([negative_caption]).to(self.device)
            un_ctx, un_pooled = self.encode_text(un_ids, un_ids)
        time_ids = torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32,
                                device=self.device)
        ac = self.schedule.table(self.device)
        n_train = self.schedule.num_train_timesteps
        steps = np.linspace(n_train - 1, 0, num_steps).round().astype(np.int64)

        def eps_x0(x, t, c, pl):
            pred = self.model.unet(x, torch.full((1,), int(t), dtype=torch.int32,
                                                 device=self.device), c, pl, time_ids).float()
            a, o = torch.sqrt(ac[t]), torch.sqrt(1.0 - ac[t])
            if self.v_pred:
                return o * x + a * pred, a * x - o * pred
            return pred, (x - o * pred) / a

        if noise is not None:
            x = noise.to(self.device, torch.float32)
        else:
            x = torch.randn((1, 4, height // 8, width // 8), generator=generator,
                            dtype=torch.float32, device=self.device)
        for i in range(num_steps):
            t = int(steps[i])
            eps, x0 = eps_x0(x, t, ctx, pooled)
            if guidance_scale != 1.0:
                eps_u, _ = eps_x0(x, t, un_ctx, un_pooled)
                eps = eps_u + guidance_scale * (eps - eps_u)
                x0 = (x - torch.sqrt(1.0 - ac[t]) * eps) / torch.sqrt(ac[t])
            a_prev = ac[int(steps[i + 1])] if i + 1 < num_steps else torch.ones_like(ac[0])
            x = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return x

    # --- weights and export -----------------------------------------------------

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The UNet from model.unet_path or checkpoint_path (an original-SD
        single file or diffusers keys), else diffusers_path/unet, with
        model.merge_adapters fused in first; the towers from
        diffusers_path/text_encoder and text_encoder_2 (not under `_tiny` or
        `_random_te`). Port names under unet. / text_encoder. /
        text_encoder_2."""
        from .sdxl_convert import convert_diffusers_sdxl_unet, convert_sd_unet_to_diffusers
        from .weights import load_safetensors_dir, merge_adapters_into_state_dict

        mc = self.model_config
        path = (mc.get("unet_path") or mc.get("checkpoint_path")
                or str(Path(mc["diffusers_path"]) / "unet"))
        sd = merge_adapters_into_state_dict(load_safetensors_dir(path),
                                            mc.get("merge_adapters", []))
        if any("model.diffusion_model." in k or k.startswith("input_blocks.") for k in sd):
            sd = convert_sd_unet_to_diffusers(sd)
        out = {f"unet.{k}": v for k, v in convert_diffusers_sdxl_unet(sd, self.unet_config).items()}
        if not (mc.get("_tiny", False) or mc.get("_random_te", False)):
            for sub in ("text_encoder", "text_encoder_2"):
                te = load_safetensors_dir(str(Path(mc["diffusers_path"]) / sub))
                out.update({f"{sub}.{k}": v for k, v in te.items()
                            if not k.endswith("position_ids")})
        return out

    def save_adapter(self, out_dir, trainable) -> None:
        """The LoRA (or LoKr) factors under kohya sd-scripts keys
        (adapter_model.safetensors): the JAX export's keys and bits."""
        from .. import safetensors_io
        from .sdxl_convert import export_sdxl_lora_kohya

        sd = export_sdxl_lora_kohya(trainable, self.unet_config)
        safetensors_io.save_file(sd, str(Path(out_dir) / "adapter_model.safetensors"))

    def save_model(self, out_dir, model) -> None:
        """A fully fine-tuned model as the original SD single file
        (model.safetensors, metadata format = pt): the UNet under
        model.diffusion_model., CLIP-L under
        conditioner.embedders.0.transformer., bigG in OpenCLIP keys under
        conditioner.embedders.1.model. (text_projection stored [in, out]),
        and the VAE of model.vae_path or diffusers_path/vae, when there is
        one, under first_stage_model.; cast to save_dtype when set."""
        from .. import safetensors_io
        from .sdxl_convert import (convert_diffusers_unet_to_sd, convert_diffusers_vae_keys_to_sd,
                                   convert_hf_clip_to_openclip, export_sdxl_unet_diffusers)
        from .weights import load_safetensors_dir

        unet_sd = convert_diffusers_unet_to_sd(
            export_sdxl_unet_diffusers(model.unet.state_dict(), self.unet_config))
        state = {f"model.diffusion_model.{k}": v for k, v in unet_sd.items()}
        state.update({f"conditioner.embedders.0.transformer.{k}": v
                      for k, v in model.text_encoder.state_dict().items()})
        te2 = convert_hf_clip_to_openclip(model.text_encoder_2.state_dict())
        if "text_projection.weight" in te2:
            te2["text_projection"] = te2.pop("text_projection.weight").t().contiguous()
        state.update({f"conditioner.embedders.1.model.{k}": v for k, v in te2.items()})
        mc = self.model_config
        vae_path = mc.get("vae_path")
        if vae_path is None and mc.get("diffusers_path"):
            cand = Path(mc["diffusers_path"]) / "vae"
            vae_path = str(cand) if cand.is_dir() else None
        if vae_path:
            vae_sd = convert_diffusers_vae_keys_to_sd(load_safetensors_dir(vae_path))
            state.update({f"first_stage_model.{k}": v for k, v in vae_sd.items()})
        if "save_dtype" in self.config:
            dt = dtype_from_string(self.config["save_dtype"])
            state = {k: v.to(dt) for k, v in state.items()}
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        safetensors_io.save_file({k: v.detach().cpu() for k, v in state.items()},
                                 str(out / "model.safetensors"), metadata={"format": "pt"})
        print(f"saved {len(state)} tensors to {out / 'model.safetensors'}")

    # --- caching --------------------------------------------------------------

    def _load_vae(self):
        """The SDXL VAE on the pipeline's device in f32 (the JAX package's
        dtype for it), frozen: seeded at the tiny width under `_tiny`, else
        from model.vae_path or diffusers_path/vae (load_image_vae: diffusers
        or single-file keys)."""
        if getattr(self, "_vae", None) is None:
            from .autoencoder_kl import AutoencoderKL, VAEConfig, load_image_vae

            mc = self.model_config
            if mc.get("_tiny", False):
                vae = AutoencoderKL(VAEConfig.tiny()).to(self.device)
                vae.init_weights(torch.Generator(device=self.device).manual_seed(0))
                vae = vae.eval().requires_grad_(False)
            else:
                path = mc.get("vae_path") or str(Path(mc["diffusers_path"]) / "vae")
                sdxl = VAEConfig.sdxl()
                vae, _ = load_image_vae(path, device=self.device,
                                        scaling_factor=sdxl.scaling_factor,
                                        shift_factor=sdxl.shift_factor)
            self._vae = vae
        return self._vae

    def get_call_vae_fn(self):
        """fn(pixels [B, 3, H, W] or [B, 3, 1, H, W] in [-1, 1], numpy) ->
        {"latents": [B, 4, H/8, W/8] f32 CPU tensor}; the VAE loads at the
        first call."""

        def fn(pixels):
            vae = self._load_vae()
            x = torch.from_numpy(np.asarray(pixels, np.float32))
            if x.dim() == 5:
                x = x[:, :, 0]
            with torch.no_grad():
                return {"latents": vae.encode(x.to(self.device)).float().cpu()}

        return fn

    def get_call_text_encoder_fns(self):
        """None: the towers run in the step."""
        return []
