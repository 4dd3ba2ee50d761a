"""Cosmos-Predict2 and Anima: the MiniTrainDIT trained with flow matching.

Counterpart of diffusion_pipe_tpu/models/cosmos_predict2.py. Logit-normal
t (training/flow.py) at image_seq_len (h/2)(w/2); x_t = (1 - t) x + t n,
the target n - x, and t passed RAW in [0, 1] to the model. With
`multiscale_loss_weight`, a 2 x 2 average-pooled MSE term is added for
each threshold that the pixel side clears (921.6 px). Latents are the Wan
2.1 VAE's (models/wan_vae.py); the text is old-T5-XXL at 512 tokens with
the padded rows zeroed, cached as t5_embed.

Anima (`type = "anima"`) caches Qwen3-0.6B's final normed states and the
T5 tokenizer's ids and mask instead; its trainable LLMAdapter
(models/llm_adapter.py) runs inside the step and maps them into the T5
space, its padded rows zeroed, before the DiT. Under `[adapter]` the
adapter trains beside the adapter factors (trainable_predicate), at
`llm_adapter_lr` when set. Its weights come from `llm_adapter_path`, or
from the `llm_adapter.*` keys of the checkpoint, else its own init.

Where the port departs from the JAX package, on purpose:
- the six modulation linears of each block take the adapter (the JAX
  blocks build them without; models/cosmos_predict2_model.py);
- the trained LLMAdapter is exported: `llm_adapter.safetensors` beside
  the adapter's `adapter_model.safetensors`, and `llm_adapter.*` keys in
  a full model's `model.safetensors`, under the names that
  convert_llm_adapter and load_weights read back; the JAX exports write
  neither;
- the model's size comes from the checkpoint's keys
  (cosmos_checkpoint_layout; the JAX pipeline builds the 2 B layout
  whatever the checkpoint holds), and keys that the model does not take
  raise.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..common import dtype_from_string
from ..training.flow import TimestepDistribution, sample_timesteps
from ..training.train_state import lora_predicate
from . import register_model
from .base import BasePipeline
from .cosmos_predict2_model import CosmosPredict2Config, CosmosPredict2Transformer
from .layers import adapter_kwargs, block_kernel_kwargs, init_module_weights, remat_spec
from .llm_adapter import (LLMAdapter, LLMAdapterConfig, convert_llm_adapter,
                          export_llm_adapter)

TINY_TEXT_LENGTH = 8
# checkpoint tensors that are buffers, not weights: skipped at load, by name
SKIPPED_BUFFERS = (r"(^|\.)pos_embedder\.seq$", r"_extra_state$")
LLM_ADAPTER_FILE = "llm_adapter.safetensors"


def cosmos_predict2_keymap(cfg: CosmosPredict2Config):
    """MiniTrainDIT checkpoint keys (the reference's vendored
    cosmos_predict2_modeling names; `net.` / `diffusion_model.` wrappers
    stripped) <-> the port's names; with adaLN-LoRA, the modulations'
    `.1` and `.2` linears, without it `.1` alone. LoRA in the ComfyUI
    dialect (`diffusion_model.` prefix)."""
    from .keymaps import BlockGroup, KeyMap

    linears = {f"{p}_{ours}": f"{p}.{theirs}" for p in ("self_attn", "cross_attn")
               for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                    ("o", "output_proj"))}
    linears.update(mlp_1="mlp.layer1", mlp_2="mlp.layer2")
    parts = (1, 2) if cfg.use_adaln_lora else (1,)
    for sub in ("self_attn", "cross_attn", "mlp"):
        for j in parts:
            linears[f"adaln_modulation_{sub}_{j}"] = f"adaln_modulation_{sub}.{j}"
    norms = {f"{p}_{n}_norm": f"{p}.{n}_norm" for p in ("self_attn", "cross_attn")
             for n in ("q", "k")}
    top = {"x_embedder": "x_embedder.proj.1", "t_embedder_1": "t_embedder.1.linear_1",
           "t_embedder_2": "t_embedder.1.linear_2",
           "final_adaln_1": "final_layer.adaln_modulation.1",
           "final_linear": "final_layer.linear"}
    if cfg.use_adaln_lora:
        top["final_adaln_2"] = "final_layer.adaln_modulation.2"
    return KeyMap(blocks=[BlockGroup("blocks", "blocks", "num_blocks", linears=linears,
                                     norms=norms)],
                  top_linears=top, top_norms={"t_embedding_norm": "t_embedding_norm"},
                  strip_prefixes=("model.diffusion_model.", "diffusion_model.", "net."),
                  lora_prefix="diffusion_model.")


def cosmos_checkpoint_layout(sd, cfg: CosmosPredict2Config) -> Dict[str, Any]:
    """What a (prefix-stripped, Predict2-named) checkpoint holds: the width
    (x_embedder's rows), the block count, the heads (width over q_norm's
    length), the cross-attention width (cross_attn.k_proj's columns),
    whether adaLN-LoRA is on (the modulations' `.2` linears) and its dim,
    the MLP ratio, and the input and output channels (x_embedder's columns
    over the patch, less the padding-mask channel; final_layer.linear's
    rows over the patch). A key the layout needs and sd lacks raises
    KeyError naming it."""
    from .keymaps import count_blocks

    def shape(key):
        if key not in sd:
            raise KeyError(f"the checkpoint lacks {key}, which its layout is read from")
        return tuple(sd[key].shape)

    patch = cfg.patch_spatial ** 2 * cfg.patch_temporal
    dim, cols = shape("x_embedder.proj.1.weight")
    lora_on = "blocks.0.adaln_modulation_self_attn.2.weight" in sd
    layout = dict(model_channels=dim, num_blocks=count_blocks(sd, "blocks"),
                  num_heads=dim // shape("blocks.0.self_attn.q_norm.weight")[0],
                  crossattn_emb_channels=shape("blocks.0.cross_attn.k_proj.weight")[1],
                  use_adaln_lora=lora_on,
                  mlp_ratio=shape("blocks.0.mlp.layer1.weight")[0] / dim,
                  in_channels=cols // patch - int(cfg.concat_padding_mask),
                  out_channels=shape("final_layer.linear.weight")[0] // patch)
    if lora_on:
        layout["adaln_lora_dim"] = shape("blocks.0.adaln_modulation_self_attn.1.weight")[0]
    return layout


def skip_buffers(sd):
    """sd without the checkpoint's non-weight buffers (SKIPPED_BUFFERS)."""
    return {k: v for k, v in sd.items() if not any(re.search(p, k) for p in SKIPPED_BUFFERS)}


@register_model("cosmos_predict2", "anima")
class CosmosPredict2Pipeline(BasePipeline):
    name = "cosmos_predict2"
    framerate = 16
    # pixel side-length thresholds that gate each successive 2 x 2 pooling
    MULTISCALE_LOSS_THRESHOLDS = (1024 * 0.9,)
    # [model] knobs that set the DiT's size (Cosmos-1's; Predict2 reads none)
    SIZE_KNOBS = ()

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.anima = self.model_config["type"] == "anima"
        if self.anima:
            self.name = "anima"  # its own cache directory, as in JAX
        self.cp_config = self._build_config()
        self.adapter_config = self._adapter_config() if self.anima else None
        self._build_model()

    # --- the model ------------------------------------------------------------

    def _build_config(self, layout: Optional[Dict] = None) -> CosmosPredict2Config:
        """The published layout (or the `_tiny` test sizes), the [model] size
        knobs over it, and `layout` (read from a checkpoint) over those."""
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype,
                                      remat=remat_spec(self.config), **block_kernel_kwargs(mc))
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        tiny = mc.get("_tiny", False)
        if not tiny:
            kwargs.update(self.published_layout())
            kwargs.update({k: int(mc[k]) for k in self.SIZE_KNOBS if mc.get(k) is not None})
        kwargs.update(layout or {})
        if tiny:
            return CosmosPredict2Config.tiny(**kwargs)
        return CosmosPredict2Config(**kwargs)

    def published_layout(self) -> Dict[str, Any]:
        """Cosmos-Predict2-2B: 28 blocks, 2,048 wide, 16 heads."""
        return dict(model_channels=2048, num_blocks=28, num_heads=16)

    def _adapter_config(self) -> LLMAdapterConfig:
        """Anima's published adapter: Qwen3-0.6B's 1,024 wide states into
        the DiT's cross-attention width, 1,024 wide, 6 layers, with
        self-attention, as the reference builds it (no [model] option sets
        it; convert_llm_adapter raises on weights of another layout)."""
        target = self.cp_config.crossattn_emb_channels
        if self.model_config.get("_tiny", False):
            return LLMAdapterConfig.tiny(source_dim=16, target_dim=target, model_dim=32)
        return LLMAdapterConfig(target_dim=target, self_attn=True)

    def _build_model(self):
        with torch.device("meta"):
            adapter = LLMAdapter(self.adapter_config) if self.anima else None
            self.model = CosmosPredict2Transformer(self.cp_config, adapter)

    def init_params(self, generator: torch.Generator) -> None:
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    def trainable_predicate(self):
        """Anima under `[adapter]`: the adapter factors and every parameter
        of its LLMAdapter, which trains beside them; else the default."""
        if not (self.anima and "adapter" in self.config):
            return super().trainable_predicate()

        def predicate(name, _param=None):
            return lora_predicate(name) or "llm_adapter" in name.split(".")

        return predicate

    def lr_scale_map(self, base_lr) -> Dict[str, float]:
        """Per-module LR groups, matched by substring, the last match
        winning: self_attn_lr, cross_attn_lr, mlp_lr, then mod_lr for the
        modulations (the blocks' adaln_modulation_* and final_adaln), then
        Anima's llm_adapter_lr."""
        mc = self.model_config
        out = {}
        for key, sub in (("self_attn_lr", "self_attn"), ("cross_attn_lr", "cross_attn"),
                         ("mlp_lr", "mlp_")):
            if mc.get(key) is not None:
                out[sub] = float(mc[key]) / base_lr
        if out or mc.get("mod_lr") is not None:
            f = float(mc["mod_lr"]) / base_lr if mc.get("mod_lr") is not None else 1.0
            out["adaln_modulation"] = f
            out["final_adaln"] = f
        if self.anima and mc.get("llm_adapter_lr") is not None:
            out["llm_adapter"] = float(mc["llm_adapter_lr"]) / base_lr
        return out

    # --- training -------------------------------------------------------------

    def _latent_mask(self, batch, b, h, w):
        mask = batch.get("mask")
        if mask is None:
            return None
        mask = F.interpolate(mask.to(self.device).float()[:, None], size=(h, w),
                             mode="nearest-exact")
        return mask[:, :, None]

    def _text_inputs(self, batch, b):
        if self.anima:
            dev = self.device
            return dict(llm_hidden_states=batch["llm_hidden_states"].to(dev),
                        llm_mask=batch["llm_mask"].to(dev).reshape(b, -1),
                        t5_input_ids=batch["t5_input_ids"].to(dev).reshape(b, -1).long(),
                        t5_mask=batch["t5_mask"].to(dev).reshape(b, -1).to(torch.int32))
        return dict(context=batch["t5_embed"].to(self.device))

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 16, F, H, W] (or [B, 16, H, W]), the cached
        text (t5_embed; Anima: llm_hidden_states, llm_mask, t5_input_ids,
        t5_mask), optional mask [B, Hm, Wm] (nearest-resized to [B, 1, 1, H,
        W])."""
        latents = batch["latents"].to(self.device, torch.float32)
        if latents.dim() == 4:
            latents = latents[:, :, None]
        b, _, _, h, w = latents.shape
        mask = self._latent_mask(batch, b, h, w)
        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator, quantile=timestep_quantile,
                                 image_seq_len=(h // 2) * (w // 2), device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32).reshape(latents.shape)
        t_exp = t.reshape(b, 1, 1, 1, 1)
        x_t = (1 - t_exp) * latents + t_exp * noise
        inputs = dict(x=x_t.to(self.cp_config.dtype), t=t, **self._text_inputs(batch, b))
        return inputs, noise - latents, mask

    def forward(self, model_inputs):
        """The DiT on the cached T5 features, or for Anima on its adapter's
        output with the padded T5 rows zeroed."""
        mi = dict(model_inputs)
        if not self.anima:
            return self.model(**mi)
        t5_mask = mi.pop("t5_mask")
        context = self.model.llm_adapter(mi.pop("llm_hidden_states"), mi.pop("t5_input_ids"),
                                         target_mask=t5_mask, source_mask=mi.pop("llm_mask"))
        return self.model(context=context * t5_mask[..., None].to(context.dtype), **mi)

    def loss_fn(self, output, target, mask):
        """The masked loss, plus with `model.multiscale_loss_weight` a 2 x 2
        average-pooled MSE term (of the first frame) for each threshold the
        pixel side length (latent side x 8) clears, over the total weight."""
        base = super().loss_fn(output, target, mask)
        weight = self.model_config.get("multiscale_loss_weight")
        if not weight:
            return base
        o, tgt = output.float()[:, :, 0], target.float()[:, :, 0]
        h, w = tgt.shape[-2:]
        side = float(np.sqrt(h * w)) * 8
        terms, total = [base], 1.0
        for thresh in self.MULTISCALE_LOSS_THRESHOLDS:
            if side < thresh:
                break
            o, tgt = F.avg_pool2d(o, 2), F.avg_pool2d(tgt, 2)
            terms.append(torch.mean((o - tgt) ** 2) * weight)
            total += weight
        return sum(terms) / total

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, noise: Optional[torch.Tensor] = None,
               num_frames: int = 1, **embeds):
        """Euler flow sampling through the training forward (Anima through
        its adapter): latents [B, 16, F, height/8, width/8] f32, F = (frames
        - 1) // 4 + 1, model.shift as the sigmas' shift."""
        from ..training.sampling import euler_flow_sample

        cfg = self.cp_config
        first = embeds["llm_hidden_states" if self.anima else "t5_embed"]
        b = first.shape[0]
        text = self._text_inputs({k: torch.as_tensor(v) for k, v in embeds.items()
                                  if k != "caption"}, b)
        f = max(1, (int(num_frames) - 1) // 4 + 1)

        def vel(x, t):
            return self.forward(dict(x=x.to(cfg.dtype), t=t, **text)).float()

        return euler_flow_sample(vel, (b, cfg.in_channels, f, height // 8, width // 8),
                                 generator, num_steps=num_steps, guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift"), noise=noise,
                                 device=self.device)

    # --- caching encoders -------------------------------------------------------

    def _load_vae(self):
        """The Wan 2.1 VAE on the pipeline's device in the model dtype,
        frozen: under `_tiny` the JAX hook's small layout, seeded; else
        model.vae_path (the reference checkpoint layout)."""
        if getattr(self, "_vae", None) is None:
            from .wan_vae import WanVAEConfig, WanVideoVAE
            from .wan_vae_convert import load_wan_vae

            mc = self.model_config
            dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
            if mc.get("_tiny", False):
                vae = WanVideoVAE(WanVAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 4),
                                               num_res_blocks=1, temperal_downsample=(True, True),
                                               dtype=dtype)).to(self.device)
                vae.init_weights(torch.Generator(device=self.device).manual_seed(0))
                vae = vae.eval().requires_grad_(False)
            else:
                vae = load_wan_vae(mc["vae_path"], dtype=dtype, device=self.device)
            self._vae = vae
        return self._vae

    def get_call_vae_fn(self):
        """fn(pixels [B, 3, F, H, W] or [B, 3, H, W] in [-1, 1], numpy) ->
        {"latents": [B, 16, 1 + (F - 1) / 4, H / 8, W / 8]} f32 CPU tensors."""

        def fn(pixels):
            vae = self._load_vae()
            px = torch.from_numpy(np.asarray(pixels, np.float32))
            if px.dim() == 4:
                px = px[:, :, None]
            with torch.no_grad():
                return {"latents": vae.encode(px.to(self.device)).float().cpu()}

        return fn

    def _tiny_text_fn(self):
        """The JAX `_tiny` hooks' seeded draws: t5_embed [8, ctx] per caption;
        Anima: llm_hidden_states [8, 16], ids in [0, 63) and all-ones masks."""
        from ..data.bucketing import seed_from_hash

        width = self.cp_config.crossattn_emb_channels
        n = TINY_TEXT_LENGTH

        def te(captions):
            return {"t5_embed": torch.from_numpy(np.stack([
                np.random.default_rng(seed_from_hash(c)).standard_normal((n, width))
                .astype(np.float32) for c in captions]))}

        def te_anima(captions):
            out = {"llm_hidden_states": [], "llm_mask": [], "t5_input_ids": [], "t5_mask": []}
            for c in captions:
                r = np.random.default_rng(seed_from_hash(c))
                out["llm_hidden_states"].append(r.standard_normal((n, 16)).astype(np.float32))
                out["llm_mask"].append(np.ones((n,), np.int32))
                out["t5_input_ids"].append(r.integers(0, 63, (n,)).astype(np.int32))
                out["t5_mask"].append(np.ones((n,), np.int32))
            return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}

        return te_anima if self.anima else te

    def _text_encoder_fp8(self) -> bool:
        mc = self.model_config
        if mc.get("text_encoder_nf4"):
            warnings.warn("text_encoder_nf4: the text encoder is stored in float8_e4m3 instead "
                          "of nf4 (no bitsandbytes kernels): half the bf16 footprint, twice "
                          "nf4's.", stacklevel=3)
            return True
        return bool(mc.get("text_encoder_fp8", False))

    def get_call_text_encoder_fns(self):
        """[fn]: captions -> the cached text. Predict2: old-T5-XXL's last
        states [B, 512, 1,024] with the padded rows zeroed, as t5_embed (a
        causal-LM folder goes through LLMTextEncoder's final normed states
        instead). Anima: Qwen3's final normed states and mask at
        max_sequence_length (default 512), and the T5 tokenizer's ids and
        mask at 512. Under `_tiny`, seeded stand-ins."""
        from .llm_encoders import LLMTextEncoder
        from .text_encoders import HFTextEncoder, _model_type

        mc = self.model_config
        if mc.get("_tiny", False):
            return [self._tiny_text_fn()]
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        if self.anima:
            from transformers import AutoTokenizer

            qwen = LLMTextEncoder(mc["text_encoder_path"],
                                  max_length=int(mc.get("max_sequence_length", 512)),
                                  hidden_layer=-1, dtype=te_dtype, device=self.device)
            t5_tok = AutoTokenizer.from_pretrained(mc["t5_tokenizer_path"])

            def anima_fn(captions):
                h, m = qwen.encode(captions)
                tok = t5_tok(captions, padding="max_length", truncation=True, max_length=512,
                             return_tensors="pt")
                return {"llm_hidden_states": h, "llm_mask": m.to(torch.int32),
                        "t5_input_ids": tok["input_ids"].to(torch.int32),
                        "t5_mask": tok["attention_mask"].to(torch.int32)}

            return [anima_fn]
        path = mc.get("t5_path") or mc["text_encoder_path"]
        fp8 = self._text_encoder_fp8()
        if "t5" in (_model_type(path) or "t5"):
            enc = HFTextEncoder("t5", path, max_length=512, device=self.device, dtype=te_dtype,
                                fp8=fp8)

            def t5_fn(captions):
                h, m = enc.encode(captions, return_mask=True)
                return {"t5_embed": h * m[..., None].to(h.dtype)}

            return [t5_fn]
        lm = LLMTextEncoder(path, max_length=512, hidden_layer=-1, dtype=te_dtype, fp8=fp8,
                            device=self.device)

        def lm_fn(captions):
            h, m = lm.encode(captions)
            return {"t5_embed": h * m[..., None].to(h.dtype)}

        return [lm_fn]

    # --- weights ----------------------------------------------------------------

    def _keymap_config(self):
        return self.cp_config

    def keymap(self):
        return cosmos_predict2_keymap(self.cp_config)

    def _raw_checkpoint(self):
        """The named checkpoint, prefixes stripped, buffers skipped."""
        from .keymaps import load_sd_for_pipeline, strip_known_prefixes

        return skip_buffers(strip_known_prefixes(load_sd_for_pipeline(self), self.keymap()))

    def _apply_layout(self, sd):
        """Rebuild the model on the checkpoint's layout (a [model] size that
        disagrees with it raises)."""
        from .keymaps import layout_override

        layout = layout_override(self.model_config, cosmos_checkpoint_layout(sd, self.cp_config))
        if any(getattr(self.cp_config, k) != v for k, v in layout.items()):
            self.cp_config = self._build_config(layout)
            if self.anima:
                self.adapter_config = dataclasses.replace(
                    self.adapter_config, target_dim=self.cp_config.crossattn_emb_channels)
            self._build_model()

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The DiT the model config names as the port's state dict, the
        model rebuilt on the checkpoint's layout; Anima's adapter from
        llm_adapter_path, else from the checkpoint's llm_adapter.* keys
        (else it keeps its init). A key missing, or one that neither takes,
        raises."""
        from .keymaps import keymap_to_state_dict
        from .weights import load_state_dict_any

        sd = self._raw_checkpoint()
        adapter_sd = {k: sd.pop(k) for k in [k for k in sd if k.startswith("llm_adapter.")]}
        self._apply_layout(sd)
        out = keymap_to_state_dict(sd, self.keymap(), self.cp_config)
        mc = self.model_config
        if adapter_sd and not self.anima:
            raise KeyError(f"{self.name}: the checkpoint holds {len(adapter_sd)} llm_adapter "
                           "keys, which only Anima takes")
        if self.anima and mc.get("llm_adapter_path"):
            if adapter_sd:
                print(f"{len(adapter_sd)} llm_adapter keys of the checkpoint are replaced by "
                      f"model.llm_adapter_path")
            adapter_sd = load_state_dict_any(mc["llm_adapter_path"])
        if self.anima and adapter_sd:
            conv = convert_llm_adapter(adapter_sd, self.adapter_config)
            out.update({f"llm_adapter.{k}": v for k, v in conv.items()})
        return out

    def save_adapter(self, out_dir, trainable) -> None:
        """The adapter factors (BasePipeline.save_adapter), and for Anima
        the trained LLMAdapter as out_dir/llm_adapter.safetensors."""
        super().save_adapter(out_dir, trainable)
        if self.anima:
            from .. import safetensors_io

            sd = export_llm_adapter(trainable)
            safetensors_io.save_file(sd, str(Path(out_dir) / LLM_ADAPTER_FILE),
                                     metadata={"format": "pt"})
            print(f"saved {len(sd)} LLMAdapter tensors to {Path(out_dir) / LLM_ADAPTER_FILE}")

    def load_adapter(self, path) -> Dict[str, torch.Tensor]:
        """adapter.init_from_existing: the adapter factors, and for Anima the
        LLMAdapter of llm_adapter.safetensors beside them when there."""
        out = super().load_adapter(path)
        folder = Path(path) if Path(path).is_dir() else Path(path).parent
        if self.anima and (folder / LLM_ADAPTER_FILE).is_file():
            from .weights import load_safetensors_dir

            conv = convert_llm_adapter(load_safetensors_dir(folder / LLM_ADAPTER_FILE),
                                       self.adapter_config)
            out.update({f"llm_adapter.{k}": v for k, v in conv.items()})
            print(f"init_from_existing: loaded {len(conv)} LLMAdapter tensors")
        return out

    def save_model(self, out_dir, model) -> None:
        """BasePipeline.save_model, with Anima's LLMAdapter under the
        checkpoint's llm_adapter.* names in the same file."""
        if not self.anima:
            return super().save_model(out_dir, model)
        adapter = export_llm_adapter(model.state_dict())
        self._passthrough_sd = {**getattr(self, "_passthrough_sd", {}), **adapter}
        return super().save_model(out_dir, model)

