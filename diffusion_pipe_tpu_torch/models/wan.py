"""Wan 2.1 / 2.2 pipeline: training inputs, weights, export and the caching
encoders around WanTransformer.

Counterpart of diffusion_pipe_tpu/models/wan.py:
- the variant table (t2v-1.3b, t2v-14b, i2v-14b, ti2v-5b, i2v-a14b) and
  autodetect_wan_variant from a checkpoint folder; the cache name (wan,
  wan_ti2v, skyreels_v2, skyreels_v2_i2v) and framerate (16; 24 for ti2v
  and SkyReels) rules, so a cache written by either package reads in the
  other;
- prepare_inputs: flow matching on 5-D video latents with logit-normal t
  (image_seq_len = (h/2)(w/2)), the text embeddings zero-padded to text_len
  and zeroed past each sample's seq_len, an optional loss mask resized to
  the latent grid, t scaled to [0, 1000]; i2v / flf2v / i2v_v2 concatenate
  the four first-frame (flf2v: and last-frame) mask channels and the
  conditioning latents y to x_t, and i2v / flf2v pass the CLIP-vision
  context. The noise and t come from a torch.Generator, or are passed in
  (the tests feed the JAX package's draws);
- with model.cache_text_embeddings = false, captions ride in the batch,
  host_prepare tokenizes them and prepare_inputs runs UMT5 without
  gradients. Unlike the JAX package, which still caches the embeddings
  then and so never reaches its in-step encoder, the port then caches no
  text embeddings;
- the caching phase's functions: the Wan 2.1 VAE (the 2.2 VAE for ti2v),
  the i2v conditioning clip y and the CLIP-vision context, and UMT5-XXL,
  each built at its first call; under the `_tiny` test hook a small seeded
  VAE, seeded UMT5-shaped text draws and a deterministic CLIP stand-in (the
  JAX hooks' values for the text and CLIP stand-ins);
- load_weights (convert_wan_weights, official or ComfyUI keys),
  save_adapter (export_wan_lora_comfyui) and save_model
  (export_wan_model, the official layout).
Not ported: block swap and prefetch, sequence sharding, the
pipeline-parallel program and sampling.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..common import dtype_from_string
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .flux import resize_mask_to_latents
from .layers import adapter_kwargs, block_kernel_kwargs, init_module_weights, remat_spec
from .wan_model import WanConfig, WanTransformer

WAN_VARIANTS = {
    "t2v-1.3b": dict(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30),
    "t2v-14b": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40),
    "i2v-14b": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                    model_type="i2v", in_dim=36),
    "ti2v-5b": dict(dim=3072, ffn_dim=14336, num_heads=24, num_layers=30,
                    model_type="ti2v", in_dim=48, out_dim=48, patch_size=(1, 2, 2)),
    # Wan2.2 I2V A14B (no CLIP k_img branch)
    "i2v-a14b": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
                     model_type="i2v_v2", in_dim=36),
}
# the `_tiny` hook's input channels by variant type (flf2v and i2v_v2 take
# i2v's 36, which the JAX hook leaves at 16)
_TINY_IN_DIM = {"i2v": 36, "flf2v": 36, "i2v_v2": 36, "ti2v": 8}

# config keys of the JAX pipeline that select paths not ported yet, and
# their ROADMAP items
_NOT_PORTED_TOP = {"blocks_to_swap": "A10", "stream_prefetch": "A10",
                   "swap_activation_checkpointing": "A10", "sequence_sharding": "A11"}


def autodetect_wan_variant(ckpt_dir):
    """(variant, skyreels) of a checkpoint folder: config.json's model_type
    and dim (low_noise_model/config.json for a Wan2.2 A14B folder), the
    safetensors keys for the Wan2.1 i2v CLIP branch (cross_attn.k_img), and
    "skyreels" in the folder's name."""
    from .. import safetensors_io

    d = Path(ckpt_dir)
    cfg_path = d / "config.json"
    if not cfg_path.exists() and (d / "low_noise_model" / "config.json").exists():
        cfg_path = d / "low_noise_model" / "config.json"
    jc = json.loads(cfg_path.read_text())
    model_type, dim = jc["model_type"], jc["dim"]
    skyreels = "skyreels" in d.name.lower()
    if model_type == "t2v":
        variant = "t2v-1.3b" if dim == 1536 else "t2v-14b"
    elif model_type == "i2v":
        shards = sorted(d.glob("*.safetensors")) or sorted(d.glob("**/*.safetensors"))
        keys = {k for shard in shards for k in safetensors_io.read_keys(shard)}
        has_k_img = not shards or any("cross_attn.k_img." in k for k in keys)
        variant = "i2v-14b" if has_k_img else "i2v-a14b"
    elif model_type == "flf2v":
        variant = "i2v-14b"
    elif model_type == "ti2v":
        variant = "ti2v-5b"
    else:
        raise RuntimeError(f"Unknown wan model_type {model_type!r}")
    return variant, skyreels


@register_model("wan", "wan21", "wan22")
class WanPipeline(BasePipeline):
    name = "wan"

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        mc = self.model_config
        for key, item in _NOT_PORTED_TOP.items():
            if config.get(key):
                raise NotImplementedError(f"{key} is not ported yet (ROADMAP {item})")
        self.tdist = TimestepDistribution.from_model_config(mc)
        self._skyreels = False
        self.wan_config = self._build_wan_config()
        # parameters are allocated by init_params, on the pipeline's device
        with torch.device("meta"):
            self.model = WanTransformer(self.wan_config)
        self.framerate = 24 if (self.wan_config.model_type == "ti2v" or self._skyreels) else 16
        if self._skyreels:  # a cache of its own
            self.name = "skyreels_v2_i2v" if self.is_i2v else "skyreels_v2"
        elif self.wan_config.model_type == "ti2v":
            # ti2v caches through the Wan2.2 VAE (48 channels, 16x)
            self.name = "wan_ti2v"
        self.cache_text = bool(mc.get("cache_text_embeddings", True))
        self.pass_captions_to_batch = not self.cache_text

    @property
    def is_i2v(self) -> bool:
        return self.wan_config.model_type in ("i2v", "flf2v", "i2v_v2")

    @property
    def uses_clip(self) -> bool:
        return self.wan_config.uses_clip

    def _build_wan_config(self) -> WanConfig:
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype,
                                      remat=remat_spec(self.config),
                                      **block_kernel_kwargs(mc))
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        if mc.get("_tiny", False):  # test hook
            vt = mc.get("variant_type", "t2v")
            return WanConfig.tiny(model_type=vt, in_dim=_TINY_IN_DIM.get(vt, 16),
                                  out_dim=8 if vt == "ti2v" else 16, **kwargs)
        variant = mc.get("variant")
        if variant is None and mc.get("ckpt_path"):
            variant, self._skyreels = autodetect_wan_variant(mc["ckpt_path"])
        elif variant is None:
            variant = "t2v-1.3b"
        if mc.get("skyreels"):
            self._skyreels = True
        if variant not in WAN_VARIANTS:
            raise NotImplementedError(f"wan variant {variant!r}")
        if mc.get("num_layers"):  # depth override
            kwargs["num_layers"] = int(mc["num_layers"])
        return WanConfig(**{**WAN_VARIANTS[variant], **kwargs})

    def init_params(self, generator: torch.Generator) -> None:
        """Allocate every weight on the pipeline's device and fill it as the
        JAX package initialises it: lecun-normal kernels (the patch
        embedding's over its C*kt*kh*kw fan-in), zero biases, modulation
        tables normal / sqrt(dim), norm scales one, LoRA A uniform (stored
        unshifted) and B zero."""
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    # --- uncached text (UMT5 in the step) -------------------------------------

    def _t5_encoder(self):
        """The frozen UMT5 encoder on the pipeline's device, built at its
        first call: seeded at the tiny width under `_tiny`, else UMT5-XXL
        from model.llm_path (ComfyUI keys), its matmul weights stored in
        float8 under model.text_encoder_fp8."""
        if getattr(self, "_t5", None) is None:
            from .text_encoders import cast_te_params_fp8
            from .umt5 import UMT5Config, UMT5Encoder, convert_umt5_comfy
            from .weights import load_safetensors_dir

            mc = self.model_config
            if mc.get("_tiny", False):
                enc = UMT5Encoder(UMT5Config.tiny()).to(self.device)
                enc.init_weights(torch.Generator(device=self.device).manual_seed(7))
            else:
                cfg = UMT5Config.xxl()
                sd = convert_umt5_comfy(load_safetensors_dir(mc["llm_path"]), cfg)
                sd = {k: v.to(cfg.param_dtype) for k, v in sd.items()}
                if mc.get("text_encoder_fp8"):
                    sd = cast_te_params_fp8(sd)
                with torch.device("meta"):
                    enc = UMT5Encoder(cfg)
                enc.load_state_dict({k: v.to(self.device) for k, v in sd.items()}, assign=True)
            self._t5 = enc.eval().requires_grad_(False)
        return self._t5

    def _tokenize_t5(self, captions):
        """(ids, mask) [B, text_len] int32: the `_tiny` hook's character
        codes, else the UMT5 tokenizer padded to text_len."""
        mc = self.model_config
        n = self.wan_config.text_len
        if mc.get("_tiny", False):
            ids = np.zeros((len(captions), n), np.int32)
            mask = np.zeros((len(captions), n), np.int32)
            for i, c in enumerate(captions):
                toks = [ord(ch) % 128 for ch in str(c)[: n - 1]] + [1]
                ids[i, : len(toks)] = toks
                mask[i, : len(toks)] = 1
            return torch.from_numpy(ids), torch.from_numpy(mask)
        if getattr(self, "_t5_tok", None) is None:
            from transformers import AutoTokenizer

            self._t5_tok = AutoTokenizer.from_pretrained(
                mc.get("llm_tokenizer_path", mc["llm_path"]))
        t = self._t5_tok([str(c) for c in captions], padding="max_length", truncation=True,
                         max_length=n, return_tensors="pt")
        return t["input_ids"].to(torch.int32), t["attention_mask"].to(torch.int32)

    def host_prepare(self, batch):
        if "caption" in batch:
            ids, mask = self._tokenize_t5(list(batch["caption"]))
            batch = {k: v for k, v in batch.items() if k != "caption"}
            batch["t5_input_ids"], batch["t5_mask"] = ids, mask
        return batch

    # --- training inputs ------------------------------------------------------

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None,
                       t: Optional[torch.Tensor] = None):
        """batch: latents [B,C,F,H,W], text_embeddings [B,<=text_len,4096],
        optional seq_lens [B] (or [B,1]) and mask [B,Hm,Wm]; i2v: y
        [B,16,F,H,W], i2v / flf2v: clip_context [B,257 (514),1280]. Uncached
        text: t5_input_ids / t5_mask in place of the embeddings. noise
        [B,C,F,H,W] and t [B] are drawn from `generator` unless given."""
        cfg = self.wan_config
        if "text_embeddings" not in batch and "t5_input_ids" in batch:
            mask_t5 = batch["t5_mask"].to(self.device, torch.int32)
            with torch.no_grad():
                emb = self._t5_encoder()(batch["t5_input_ids"].to(self.device), mask_t5)
            batch = dict(batch, text_embeddings=emb.float() * mask_t5[..., None],
                         seq_lens=mask_t5.sum(1).to(torch.int32))
        latents = batch["latents"].to(self.device, torch.float32)
        b, _, f, h, w = latents.shape

        mask = batch.get("mask")
        if mask is not None:  # [B, 1, 1, h, w], broadcast over C and F
            mask = resize_mask_to_latents(mask.to(self.device), h, w, 1)[:, :, None]

        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator,
                                 quantile=timestep_quantile,
                                 image_seq_len=(h // 2) * (w // 2), device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                dtype=torch.float32, device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1, 1)
        x_t = (1.0 - t_exp) * latents + t_exp * noise
        target = noise - latents

        ctx = batch["text_embeddings"].to(self.device, torch.float32)
        pad = cfg.text_len - ctx.shape[1]
        if pad > 0:
            ctx = torch.nn.functional.pad(ctx, (0, 0, 0, pad))
        if "seq_lens" in batch:
            sl = batch["seq_lens"].to(self.device).reshape(-1)
            idx = torch.arange(cfg.text_len, device=self.device)[None, :]
            ctx = torch.where((idx < sl[:, None])[..., None], ctx, 0.0)

        if self.is_i2v:  # the first-frame (flf2v: and last-frame) mask, then y
            m4 = torch.zeros((b, 4, f, h, w), dtype=torch.float32, device=self.device)
            m4[:, :, 0] = 1.0
            if cfg.model_type == "flf2v":
                m4[:, :, -1] = 1.0
            x_t = torch.cat([x_t, m4, batch["y"].to(self.device, torch.float32)], dim=1)

        model_inputs = dict(x=x_t.to(cfg.dtype), t=t * 1000.0, context=ctx)
        if self.uses_clip:
            model_inputs["clip_fea"] = batch["clip_context"].to(self.device, cfg.dtype)
        return model_inputs, target, mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, num_frames: int = 1,
               noise: Optional[torch.Tensor] = None, **embeds):
        """Euler flow sampling through the training forward (t2v, as the JAX
        package's: 16 latent channels, no image conditioning): latents [B,
        16, 1 + (num_frames-1)//4, height/8, width/8] f32 from `noise` or the
        generator's N(0, 1), text_embeddings zero-padded to text_len, sigmas
        shifted by model.shift (3.0 by default)."""
        from ..training.sampling import euler_flow_sample

        cfg = self.wan_config
        ctx = embeds["text_embeddings"].to(self.device, torch.float32)
        pad = cfg.text_len - ctx.shape[1]
        if pad > 0:
            ctx = torch.nn.functional.pad(ctx, (0, 0, 0, pad))
        b = ctx.shape[0]
        f = max(1, (int(num_frames) - 1) // 4 + 1)

        def vel(x, t):
            return self.forward(dict(x=x.to(cfg.dtype), t=t * 1000.0, context=ctx,
                                     clip_fea=None))

        return euler_flow_sample(vel, (b, 16, f, height // 8, width // 8), generator,
                                 num_steps=num_steps, guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift", 3.0), noise=noise,
                                 device=self.device)

    # --- caching encoders -----------------------------------------------------

    def _load_vae(self):
        """The Wan 2.1 VAE (the 2.2 VAE for ti2v) on the pipeline's device in
        the model dtype, frozen: seeded at a small width under `_tiny`, else
        from model.vae_path (the reference checkpoint layout)."""
        if getattr(self, "_vae", None) is None:
            from .wan_vae import WanVAEConfig, WanVideoVAE
            from .wan_vae22 import Wan22VAEConfig, WanVideoVAE22, load_wan22_vae
            from .wan_vae_convert import load_wan_vae

            mc = self.model_config
            dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
            is_ti2v = self.wan_config.model_type == "ti2v"
            if mc.get("_tiny", False):
                if is_ti2v:
                    vae = WanVideoVAE22(Wan22VAEConfig.tiny(dtype=dtype))
                else:
                    vae = WanVideoVAE(WanVAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 4),
                                                   num_res_blocks=1,
                                                   temperal_downsample=(True, True), dtype=dtype))
                vae = vae.to(self.device)
                vae.init_weights(torch.Generator(device=self.device).manual_seed(0))
                vae = vae.eval().requires_grad_(False)
            else:
                load = load_wan22_vae if is_ti2v else load_wan_vae
                vae = load(mc["vae_path"], dtype=dtype, device=self.device)
            self._vae = vae
        return self._vae

    def get_call_vae_fn(self):
        """fn(pixels [B, 3, F, H, W] or [B, 3, H, W] in [-1, 1], numpy) ->
        {"latents": [B, z, 1 + (F-1)/4, h, w]} as f32 CPU tensors; i2v also
        gives y (the encode of the first frame followed by zeros; flf2v: and
        the last frame) and, for i2v / flf2v, clip_context [B, 257, 1280]
        of the first frame. The VAE and CLIP load at their first call."""

        def fn(pixels):
            vae = self._load_vae()
            px = torch.from_numpy(np.asarray(pixels, np.float32))
            if px.dim() == 4:
                px = px[:, :, None]
            px = px.to(self.device)

            def encode(x):
                with torch.no_grad():
                    return vae.encode(x).float().cpu()

            ret = {"latents": encode(px)}
            if self.is_i2v:
                cond = torch.cat([px[:, :, :1], torch.zeros_like(px[:, :, 1:])], dim=2)
                if self.wan_config.model_type == "flf2v":
                    cond = torch.cat([cond[:, :, :-1], px[:, :, -1:]], dim=2)
                ret["y"] = encode(cond)
                if self.uses_clip:
                    ret["clip_context"] = self._clip_visual(px[:, :, 0])
            return ret

        return fn

    def _clip_visual(self, first_frames: torch.Tensor) -> torch.Tensor:
        """[B, 257, 1280] f32 CPU CLIP-vision tokens of the first frames:
        the ViT-H/14 tower from model.clip_path, or under `_tiny` the JAX
        hook's stand-in (the frames linearly resized to 16 x 16, tiled)."""
        from .wan_clip import WanClipVision, WanClipVisionConfig, convert_wan_clip_visual
        from .wan_clip import resize_images

        if self.model_config.get("_tiny", False):
            b = first_frames.shape[0]
            feat = resize_images(first_frames, (16, 16), "linear").reshape(b, -1)
            feat = feat.repeat(1, 1 + 1280 * 257 // feat.shape[1])[:, :257 * 1280]
            return feat.reshape(b, 257, 1280).float().cpu()
        if getattr(self, "_clip", None) is None:
            from .weights import load_state_dict_any

            mc = self.model_config
            cfg = WanClipVisionConfig(dtype=dtype_from_string(mc.get("dtype", "bfloat16")))
            sd = convert_wan_clip_visual(load_state_dict_any(mc["clip_path"]), cfg)
            with torch.device("meta"):
                clip = WanClipVision(cfg)
            clip = clip.to_empty(device=self.device)
            clip.load_state_dict({k: v.to(cfg.dtype) for k, v in sd.items()})
            self._clip = clip.eval().requires_grad_(False)
        with torch.no_grad():
            return self._clip(first_frames.to(self.device)).float().cpu()

    def get_call_text_encoder_fns(self):
        """[fn(captions) -> {"text_embeddings": [B, text_len, 4096] f32 CPU,
        zero past each caption's tokens, "seq_lens": [B] int32}]: UMT5-XXL
        from model.llm_path with its tokenizer, or under `_tiny` the JAX
        hook's seeded draws (numpy's generator seeded from each caption's
        hash, len(caption) + 1 rows). No function when text embeddings are
        not cached (UMT5 runs in the step)."""
        mc = self.model_config
        cfg = self.wan_config
        if not self.cache_text:
            return []
        if mc.get("_tiny", False):
            return [seeded_umt5_fn(cfg.text_len, cfg.text_dim)]

        def te(captions):
            ids, mask = self._tokenize_t5(list(captions))
            mask = mask.to(self.device)
            with torch.no_grad():
                emb = self._t5_encoder()(ids.to(self.device), mask)
            return {"text_embeddings": (emb.float() * mask[..., None]).cpu(),
                    "seq_lens": mask.sum(1).to(torch.int32).cpu()}

        return [te]

    # --- weights and export -----------------------------------------------------

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The pretrained transformer as a state dict of the port's names,
        from model.ckpt_path (else transformer_path): the official Wan or
        ComfyUI keys, with model.merge_adapters fused in first."""
        from .weights import load_safetensors_dir, merge_adapters_into_state_dict

        mc = self.model_config
        path = mc.get("ckpt_path", mc.get("transformer_path"))
        if path is None:
            raise FileNotFoundError("model.ckpt_path (or transformer_path) is not set")
        sd = merge_adapters_into_state_dict(load_safetensors_dir(path),
                                            mc.get("merge_adapters", []))
        return convert_wan_weights(sd, self.wan_config)

    def save_adapter(self, out_dir, trainable) -> None:
        """The LoRA factors in the ComfyUI layout
        (adapter_model.safetensors): the JAX export's keys and bits."""
        from .. import safetensors_io

        sd = export_wan_lora_comfyui(trainable, self.wan_config)
        safetensors_io.save_file(sd, str(Path(out_dir) / "adapter_model.safetensors"))

    def save_model(self, out_dir, model) -> None:
        """A fully fine-tuned model in the official Wan layout
        (model.safetensors, metadata format = pt), cast to save_dtype when
        the config sets one."""
        from .. import safetensors_io

        sd = export_wan_model(model.state_dict(), self.wan_config)
        if "save_dtype" in self.config:
            dt = dtype_from_string(self.config["save_dtype"])
            sd = {k: v.to(dt) for k, v in sd.items()}
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        safetensors_io.save_file({k: v.detach().cpu() for k, v in sd.items()},
                                 str(out / "model.safetensors"), metadata={"format": "pt"})
        print(f"saved {len(sd)} tensors to {out / 'model.safetensors'}")


def seeded_umt5_fn(text_len: int, text_dim: int):
    """Stand-in UMT5 function: for each caption, len(caption) + 1 (at most
    text_len) rows of normal draws of numpy's generator seeded from the
    caption's hash, zero after (the JAX `_tiny` hook's values at any
    width), and those row counts as seq_lens."""
    from ..data.bucketing import seed_from_hash

    def te(captions):
        embs, lens = [], []
        for c in captions:
            n = min(len(c) + 1, text_len)
            e = np.zeros((text_len, text_dim), np.float32)
            e[:n] = np.random.default_rng(seed_from_hash(c)).standard_normal((n, text_dim))
            embs.append(e)
            lens.append(n)
        return {"text_embeddings": torch.from_numpy(np.stack(embs)),
                "seq_lens": torch.tensor(lens, dtype=torch.int32)}

    return te


# --- weight conversion ------------------------------------------------------

_BLOCK_LINEARS = {
    "self_attn_q": "self_attn.q",
    "self_attn_k": "self_attn.k",
    "self_attn_v": "self_attn.v",
    "self_attn_o": "self_attn.o",
    "cross_attn_q": "cross_attn.q",
    "cross_attn_k": "cross_attn.k",
    "cross_attn_v": "cross_attn.v",
    "cross_attn_o": "cross_attn.o",
    "ffn_in": "ffn.0",
    "ffn_out": "ffn.2",
}
_LOKR_LEAVES = ("lokr_w1", "lokr_w2", "lokr_w2_a", "lokr_w2_b")
_BLOCK_I2V_LINEARS = {"cross_attn_k_img": "cross_attn.k_img",
                      "cross_attn_v_img": "cross_attn.v_img"}
_BLOCK_RMS = {
    "self_attn_norm_q": "self_attn.norm_q",
    "self_attn_norm_k": "self_attn.norm_k",
    "cross_attn_norm_q": "cross_attn.norm_q",
    "cross_attn_norm_k": "cross_attn.norm_k",
}
_BLOCK_I2V_RMS = {"cross_attn_norm_k_img": "cross_attn.norm_k_img"}
_TOP_LINEARS = {
    "text_embedding_1": "text_embedding.0",
    "text_embedding_2": "text_embedding.2",
    "time_embedding_1": "time_embedding.0",
    "time_embedding_2": "time_embedding.2",
    "time_projection": "time_projection.1",
    "head": "head.head",
}
# port name -> official key, of parameters that map one to one
_TOP_PARAMS = {"patch_embedding.weight": "patch_embedding.weight",
               "patch_embedding.bias": "patch_embedding.bias",
               "head_modulation": "head.modulation"}
_IMG_EMB_PARAMS = {"img_emb_norm1_scale": "img_emb.proj.0.weight",
                   "img_emb_norm1_bias": "img_emb.proj.0.bias",
                   "img_emb_norm2_scale": "img_emb.proj.4.weight",
                   "img_emb_norm2_bias": "img_emb.proj.4.bias"}
_IMG_EMB_LINEARS = {"img_emb_1": "img_emb.proj.1", "img_emb_2": "img_emb.proj.3"}


def _block_maps(cfg: WanConfig):
    lin, rms = dict(_BLOCK_LINEARS), dict(_BLOCK_RMS)
    if cfg.uses_clip:
        lin.update(_BLOCK_I2V_LINEARS)
        rms.update(_BLOCK_I2V_RMS)
    return lin, rms


def _name_pairs(cfg: WanConfig):
    """(port name, official key) of every pretrained parameter: torch
    layouts carry over, RMSNorm `scale` is the official `weight`."""
    lin, rms = _block_maps(cfg)
    top_lin = dict(_TOP_LINEARS, **(_IMG_EMB_LINEARS if cfg.uses_clip else {}))
    for ours, theirs in top_lin.items():
        yield f"{ours}.weight", f"{theirs}.weight"
        yield f"{ours}.bias", f"{theirs}.bias"
    yield from _TOP_PARAMS.items()
    if cfg.uses_clip:
        yield from _IMG_EMB_PARAMS.items()
    for i in range(cfg.num_layers):
        p = f"blocks.{i}"
        for ours, theirs in lin.items():
            yield f"{p}.{ours}.weight", f"{p}.{theirs}.weight"
            yield f"{p}.{ours}.bias", f"{p}.{theirs}.bias"
        for ours, theirs in rms.items():
            yield f"{p}.{ours}.scale", f"{p}.{theirs}.weight"
        yield f"{p}.norm3_scale", f"{p}.norm3.weight"
        yield f"{p}.norm3_bias", f"{p}.norm3.bias"
        yield f"{p}.modulation", f"{p}.modulation"


def convert_wan_weights(sd: Mapping[str, torch.Tensor], cfg: WanConfig) -> Dict[str, torch.Tensor]:
    """An official Wan checkpoint (blocks.N.* keys; a ComfyUI
    `diffusion_model.` prefix stripped) -> the port's state dict
    (pretrained tensors only: LoRA factors and int8 scales keep their
    initialisation when it is loaded). A key missing or left over raises
    KeyError naming it."""
    from .weights import take

    sd = {k.removeprefix("diffusion_model."): v for k, v in sd.items()}
    return take(sd, _name_pairs(cfg), "Wan checkpoint")


def export_wan_model(state_dict: Mapping[str, torch.Tensor],
                     cfg: WanConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict -> the official Wan state dict (the inverse of
    convert_wan_weights)."""
    return {theirs: state_dict[ours] for ours, theirs in _name_pairs(cfg)}


def export_wan_lora_comfyui(trainable: Mapping[str, torch.Tensor],
                            cfg: WanConfig) -> Dict[str, torch.Tensor]:
    """Adapter factors (port names) -> ComfyUI keys
    diffusion_model.blocks.N.<official module>.lora_A.weight (lora_a [in, r]
    transposed) and .lora_B.weight (lora_b [r, out] transposed), or the LoKr
    factors .lokr_w1 / .lokr_w2 / .lokr_w2_a / .lokr_w2_b (PEFT's names,
    transposed), f32, in the JAX export's order."""
    lin, _ = _block_maps(cfg)
    out: Dict[str, torch.Tensor] = {}

    def put(dst, src):
        out[dst] = trainable[src].detach().float().t().contiguous().cpu()

    for ours, theirs in lin.items():
        for i in range(cfg.num_layers):
            key = f"blocks.{i}.{ours}"
            if f"{key}.lora_a" in trainable:
                dst = f"diffusion_model.blocks.{i}.{theirs}"
                put(f"{dst}.lora_A.weight", f"{key}.lora_a")
                put(f"{dst}.lora_B.weight", f"{key}.lora_b")
        for leaf in _LOKR_LEAVES:
            for i in range(cfg.num_layers):
                if f"blocks.{i}.{ours}.{leaf}" in trainable:
                    put(f"diffusion_model.blocks.{i}.{theirs}.{leaf}", f"blocks.{i}.{ours}.{leaf}")
    return out
