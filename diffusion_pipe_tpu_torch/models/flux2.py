"""FLUX.2 (Dev / Klein): the transformer and its pipeline.

Counterpart of diffusion_pipe_tpu/models/flux2.py: Flux's double and single
blocks with GLOBAL modulation (one set from the timestep and guidance
vector, shared by every block: double_stream_modulation_img / _txt and
single_stream_modulation), joint [txt, img] attention on K1-K3 with
multi-axis RoPE, text unmasked at its full length, 2 x 2 packed 32-channel
latents (128 channels a token), control latents of an edit after the noisy
image with the output cut to the target's rows.

The default layout is the published FLUX.2 [dev] (BFL's flux2 model,
diffusers' Flux2Transformer2DModel); with a checkpoint the layout is read
from its keys (flux2_checkpoint_layout). Where the published model differs
from the JAX module, and how the port decides:
- the MLP: SwiGLU at ratio 3, silu(first half of fc1) * second half
  (img_mlp.0 [36,864, 6,144], img_mlp.2 [6,144, 18,432]; the single
  block's linear1 emits 3 d + 2 x 18,432); the JAX module's is GELU-tanh
  at ratio 4. Gated when fc1's rows are twice fc2's columns;
- no linear has a bias; the JAX module gives the embedders, the three
  modulations and the head one. From the keys;
- RoPE on 4 axes (32, 32, 32, 32), theta 2,000, ids (t, h, w, l): the
  image (0, row, col, 0), the text (0, 0, 0, position), reference image i
  t = 10 (i + 1); the JAX module's 3 axes (16, 56, 56), theta 10,000,
  text positions on axis 0 and the reference on axis-0 index 1. No key
  holds these: the published values are the default and
  interop.flux2_config sets the JAX ones;
- the text: Mistral-Small-3.1's hidden states of layers 10, 20 and 30
  stacked per token (15,360 wide), Qwen3's 9, 18 and 27 for Klein, where
  the JAX pipeline feeds the last hidden state (flux2_text_layers);
- no txt_norm, where the JAX module RMS-normalises the text: from the keys;
- the VAE latents are normalised, 2 x 2-packed, by the VAE's batch-norm
  statistics (base.BasePipeline._generic_image_vae_fn).
SiLU reaches the global modulations and the head once, as in both.

The block linears (8 a double block, 2 a single block) take the adapter,
base_kernel_dtype (fp8 storage) and int8_matmul; the embedders, norms,
modulations and head keep param_dtype, the head computes in f32. With
`remat` set each block runs under remat_call (every policy).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common import dtype_from_string
from ..ops.attention import dot_product_attention
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .flux import pack_latents, resize_mask_to_latents, unpack_latents
from .layers import (LoraDense, RMSNorm, adapter_kwargs, apply_rope, block_kernel_kwargs,
                     init_module_weights, layer_norm, modulate, remat_call, remat_spec,
                     rope_frequencies, sinusoidal_timestep_embedding)

TINY_TEXT_LENGTH = 8
# the published hidden-state layers stacked per token, by LLM family and count
TEXT_LAYERS = {("mistral", 3): (10, 20, 30), ("qwen3", 3): (9, 18, 27)}

# what the JAX module computes, where the published model differs
JAX_LAYOUT = dict(mlp_ratio=4.0, mlp_gated=False, use_bias=True, txt_norm=True,
                  text_dim=5120, axes_dims_rope=(16, 56, 56), txt_ids_dims=(0,),
                  rope_theta=10000.0, ref_index_scale=1)


@dataclasses.dataclass(frozen=True)
class Flux2Config:
    in_channels: int = 128        # 32 latent channels x 2 x 2
    out_channels: int = 128
    latent_channels: int = 32
    hidden_size: int = 6144       # Dev; 3072 / 4096 for the Kleins
    attention_head_dim: int = 128
    num_layers: int = 8           # double blocks
    num_single_layers: int = 48
    mlp_ratio: float = 3.0
    mlp_gated: bool = True        # SwiGLU (published); GELU-tanh (JAX)
    use_bias: bool = False        # biases of the embedders, modulations and head
    txt_norm: bool = False        # RMSNorm on the text before txt_in
    text_dim: int = 15360         # 3 stacked Mistral-3 layers of 5,120
    axes_dims_rope: Tuple[int, ...] = (32, 32, 32, 32)
    txt_ids_dims: Tuple[int, ...] = (3,)
    rope_theta: float = 2000.0
    ref_index_scale: int = 10     # reference image i on axis-0 id scale * (i + 1)
    guidance_embeds: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    base_kernel_dtype: Optional[torch.dtype] = None
    int8_matmul: Any = False
    lora_rank: int = 0
    lora_alpha: float = 0.0
    lora_dropout: float = 0.0
    lora_dtype: torch.dtype = torch.float32
    lora_type: str = "lora"
    lokr_factor: int = -1
    lokr_rank_dropout: float = 0.0
    remat: str = ""

    @property
    def num_attention_heads(self) -> int:
        return self.hidden_size // self.attention_head_dim

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def fc1_dim(self) -> int:
        return self.mlp_dim * (2 if self.mlp_gated else 1)

    def dense(self, in_features: int, features: int) -> LoraDense:
        """A block linear: the adapter, fp8 storage and int8 compute."""
        return LoraDense(in_features, features, use_bias=False, dtype=self.dtype,
                         param_dtype=self.param_dtype, lora_rank=self.lora_rank,
                         lora_alpha=self.lora_alpha, lora_dropout=self.lora_dropout,
                         lora_dtype=self.lora_dtype, kernel_dtype=self.base_kernel_dtype,
                         int8_matmul=self.int8_matmul, lora_type=self.lora_type,
                         lokr_factor=self.lokr_factor, lokr_rank_dropout=self.lokr_rank_dropout)

    def top(self, in_features: int, features: int, dtype=None) -> LoraDense:
        """An embedder, modulation or head linear (no adapter)."""
        return LoraDense(in_features, features, use_bias=self.use_bias,
                         dtype=dtype or self.dtype, param_dtype=self.param_dtype)

    @staticmethod
    def tiny(**kw) -> "Flux2Config":
        """The JAX Flux2Config.tiny sizes in the published layout (4 RoPE
        axes of 2)."""
        d = dict(in_channels=16, out_channels=16, latent_channels=4, hidden_size=32,
                 attention_head_dim=8, num_layers=2, num_single_layers=2, text_dim=24,
                 axes_dims_rope=(2, 2, 2, 2), dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return Flux2Config(**d)


def _heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, -1, hd)


def _mlp_act(y: torch.Tensor, gated: bool) -> torch.Tensor:
    if gated:
        a, b = y.chunk(2, dim=-1)
        return F.silu(a) * b
    return F.gelu(y, approximate="tanh")


class Flux2DoubleBlock(nn.Module):
    """Flux's double block with the modulation given from outside."""

    def __init__(self, cfg: Flux2Config):
        super().__init__()
        self.cfg = cfg
        dim, hd = cfg.hidden_size, cfg.attention_head_dim
        for s in ("img", "txt"):
            setattr(self, f"{s}_attn_qkv", cfg.dense(dim, 3 * dim))
            setattr(self, f"{s}_attn_q_norm", RMSNorm(hd, param_dtype=cfg.param_dtype))
            setattr(self, f"{s}_attn_k_norm", RMSNorm(hd, param_dtype=cfg.param_dtype))
            setattr(self, f"{s}_attn_proj", cfg.dense(dim, dim))
            setattr(self, f"{s}_mlp_fc1", cfg.dense(dim, cfg.fc1_dim))
            setattr(self, f"{s}_mlp_fc2", cfg.dense(cfg.mlp_dim, dim))

    def _qkv(self, x, s):
        hd = self.cfg.attention_head_dim
        q, k, v = (_heads(u, hd) for u in getattr(self, f"{s}_attn_qkv")(x).chunk(3, dim=-1))
        return getattr(self, f"{s}_attn_q_norm")(q), getattr(self, f"{s}_attn_k_norm")(k), v

    def _mlp(self, x, s, shift, scale, gate):
        y = modulate(layer_norm(x), shift, scale)
        y = getattr(self, f"{s}_mlp_fc2")(_mlp_act(getattr(self, f"{s}_mlp_fc1")(y),
                                                   self.cfg.mlp_gated))
        return x + gate[:, None] * y

    def forward(self, img, txt, mods, rope_cos, rope_sin):
        (i_s1, i_sc1, i_g1, i_s2, i_sc2, i_g2,
         t_s1, t_sc1, t_g1, t_s2, t_sc2, t_g2) = mods
        iq, ik, iv = self._qkv(modulate(layer_norm(img), i_s1, i_sc1), "img")
        tq, tk, tv = self._qkv(modulate(layer_norm(txt), t_s1, t_sc1), "txt")
        q = apply_rope(torch.cat([tq, iq], dim=1), rope_cos, rope_sin)
        k = apply_rope(torch.cat([tk, ik], dim=1), rope_cos, rope_sin)
        attn = dot_product_attention(q, k, torch.cat([tv, iv], dim=1)).flatten(2)
        st = txt.shape[1]
        img = img + i_g1[:, None] * self.img_attn_proj(attn[:, st:])
        img = self._mlp(img, "img", i_s2, i_sc2, i_g2)
        txt = txt + t_g1[:, None] * self.txt_attn_proj(attn[:, :st])
        txt = self._mlp(txt, "txt", t_s2, t_sc2, t_g2)
        return img, txt


class Flux2SingleBlock(nn.Module):
    def __init__(self, cfg: Flux2Config):
        super().__init__()
        self.cfg = cfg
        dim, hd = cfg.hidden_size, cfg.attention_head_dim
        self.linear1 = cfg.dense(dim, 3 * dim + cfg.fc1_dim)
        self.q_norm = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.k_norm = RMSNorm(hd, param_dtype=cfg.param_dtype)
        self.linear2 = cfg.dense(dim + cfg.mlp_dim, dim)

    def forward(self, x, mods, rope_cos, rope_sin):
        cfg = self.cfg
        shift, scale, gate = mods
        y = self.linear1(modulate(layer_norm(x), shift, scale))
        qkv, mlp = y[..., :3 * cfg.hidden_size], y[..., 3 * cfg.hidden_size:]
        q, k, v = (_heads(u, cfg.attention_head_dim) for u in qkv.chunk(3, dim=-1))
        q = apply_rope(self.q_norm(q), rope_cos, rope_sin)
        k = apply_rope(self.k_norm(k), rope_cos, rope_sin)
        attn = dot_product_attention(q, k, v).flatten(2)
        y = self.linear2(torch.cat([attn, _mlp_act(mlp, cfg.mlp_gated)], dim=-1))
        return x + gate[:, None] * y


def flux2_latent_ids(h2: int, w2: int, index: float = 0.0, n_axes: int = 4,
                     device=None) -> torch.Tensor:
    """[h2 * w2, n_axes] f32 ids of a packed image: (index, row, col) and
    zeros on the axes after (the published 4th axis, l)."""
    row = torch.arange(h2, device=device).repeat_interleave(w2)
    col = torch.arange(w2, device=device).repeat(h2)
    ids = torch.zeros((h2 * w2, n_axes), dtype=torch.float32, device=device)
    ids[:, 0] = float(index)
    ids[:, 1] = row.float()
    ids[:, 2] = col.float()
    return ids


def flux2_text_ids(length: int, cfg: Flux2Config, device=None) -> torch.Tensor:
    """[length, n_axes] f32: the text position on each of txt_ids_dims, zero elsewhere."""
    ids = torch.zeros((length, len(cfg.axes_dims_rope)), dtype=torch.float32, device=device)
    for ax in cfg.txt_ids_dims:
        ids[:, ax] = torch.arange(length, dtype=torch.float32, device=device)
    return ids


class Flux2Transformer(nn.Module):
    def __init__(self, cfg: Flux2Config):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.img_in = cfg.top(cfg.in_channels, dim)
        if cfg.txt_norm:
            self.txt_norm = RMSNorm(cfg.text_dim, param_dtype=cfg.param_dtype)
        self.txt_in = cfg.top(cfg.text_dim, dim)
        self.time_in_1 = cfg.top(256, dim)
        self.time_in_2 = cfg.top(dim, dim)
        if cfg.guidance_embeds:
            self.guidance_in_1 = cfg.top(256, dim)
            self.guidance_in_2 = cfg.top(dim, dim)
        self.double_stream_modulation_img = cfg.top(dim, 6 * dim)
        self.double_stream_modulation_txt = cfg.top(dim, 6 * dim)
        self.single_stream_modulation = cfg.top(dim, 3 * dim)
        self.double_blocks = nn.ModuleList([Flux2DoubleBlock(cfg) for _ in range(cfg.num_layers)])
        self.single_blocks = nn.ModuleList([Flux2SingleBlock(cfg)
                                            for _ in range(cfg.num_single_layers)])
        self.final_mod = cfg.top(dim, 2 * dim)
        self.final_linear = cfg.top(dim, cfg.out_channels, dtype=torch.float32)

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(self, hidden_states, encoder_hidden_states, timestep, img_ids, guidance=None,
                img_seq_len: Optional[int] = None):
        """hidden_states [B, S_img (+ S_control), in_channels] packed latents;
        encoder_hidden_states [B, S_txt, text_dim]; timestep [B] in [0, 1];
        img_ids [S_img (+ S_control), n_axes]; guidance [B]; img_seq_len cuts
        the output to the target's rows."""
        cfg = self.cfg
        img = self.img_in(hidden_states.to(cfg.dtype))
        txt = encoder_hidden_states.to(cfg.dtype)
        if cfg.txt_norm:
            txt = self.txt_norm(txt)
        txt = self.txt_in(txt)
        temb = sinusoidal_timestep_embedding(timestep.float() * 1000.0, 256)
        vec = self.time_in_2(F.silu(self.time_in_1(temb.to(cfg.dtype))))
        if cfg.guidance_embeds and guidance is not None:
            ge = sinusoidal_timestep_embedding(guidance.float() * 1000.0, 256)
            vec = vec + self.guidance_in_2(F.silu(self.guidance_in_1(ge.to(cfg.dtype))))
        sv = F.silu(vec)
        double_mods = (*self.double_stream_modulation_img(sv).chunk(6, dim=-1),
                       *self.double_stream_modulation_txt(sv).chunk(6, dim=-1))
        single_mods = self.single_stream_modulation(sv).chunk(3, dim=-1)
        st = txt.shape[1]
        ids = torch.cat([flux2_text_ids(st, cfg, img.device), img_ids.to(img.device).float()])
        rope_cos, rope_sin = rope_frequencies(ids, cfg.axes_dims_rope, cfg.rope_theta)
        for block in self.double_blocks:
            img, txt = self._run(block, img, txt, double_mods, rope_cos, rope_sin)
        x = torch.cat([txt, img], dim=1)
        for block in self.single_blocks:
            x = self._run(block, x, single_mods, rope_cos, rope_sin)
        out = x[:, st:]
        if img_seq_len is not None:
            out = out[:, :img_seq_len]
        shift, scale = self.final_mod(sv).chunk(2, dim=-1)
        return self.final_linear(modulate(layer_norm(out), shift, scale))


def flux2_checkpoint_layout(sd) -> Dict[str, Any]:
    """The layout a (prefix-stripped) BFL / ComfyUI FLUX.2 checkpoint holds:
    widths and block counts, the head dim (the q-norm width), gated MLP or
    not (fc1's rows twice fc2's columns) and its ratio, biases, txt_norm,
    guidance and the text width."""
    from .keymaps import count_blocks

    hidden, in_ch = sd["img_in.weight"].shape
    fc1 = sd["double_blocks.0.img_mlp.0.weight"].shape[0]
    mlp = sd["double_blocks.0.img_mlp.2.weight"].shape[1]
    if fc1 not in (mlp, 2 * mlp):
        raise KeyError(f"img_mlp.0 has {fc1} rows against img_mlp.2's {mlp} columns: "
                       f"neither GELU (equal) nor SwiGLU (twice)")
    return dict(hidden_size=int(hidden), in_channels=int(in_ch),
                out_channels=int(sd["final_layer.linear.weight"].shape[0]),
                num_layers=count_blocks(sd, "double_blocks"),
                num_single_layers=count_blocks(sd, "single_blocks"),
                attention_head_dim=int(sd["double_blocks.0.img_attn.norm.query_norm.scale"]
                                       .shape[0]),
                mlp_gated=fc1 == 2 * mlp, mlp_ratio=mlp / hidden,
                use_bias="img_in.bias" in sd, txt_norm="txt_norm.scale" in sd,
                guidance_embeds="guidance_in.in_layer.weight" in sd,
                text_dim=int(sd["txt_in.weight"].shape[1]))


def flux2_text_layers(hf_config: dict, text_dim: int) -> Tuple[int, ...]:
    """The hidden-state layers whose outputs are stacked per token to give
    `text_dim` from the LLM of `hf_config` (a transformers config.json):
    (-1,), the last normed state, when text_dim is its width; the
    published layers of FLUX.2 [dev] (Mistral-3: 10, 20, 30) and Klein
    (Qwen3: 9, 18, 27) for three; anything else raises, naming them."""
    cfg = {**hf_config, **hf_config.get("text_config", {})}
    width, family = int(cfg["hidden_size"]), cfg.get("model_type", "")
    n, rem = divmod(text_dim, width)
    if rem == 0 and n == 1:
        return (-1,)
    layers = TEXT_LAYERS.get((family, n)) if rem == 0 else None
    if layers is None:
        raise ValueError(
            f"txt_in takes {text_dim} features but the {family!r} text encoder is {width} wide: "
            f"the published layouts stack {', '.join(f'{f} layers {ls}' for (f, _), ls in TEXT_LAYERS.items())}"
            f" or take the last state alone")
    return layers


@register_model("flux2")
class Flux2Pipeline(BasePipeline):
    name = "flux2"
    # the cache's encoder tags: the JAX package caches the same folder with
    # un-normalised latents and the LLM's last state alone
    latent_cache_tag = "flux2-vae-bn"
    text_cache_tag = "flux2-stacked-layers"

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.f2_config = self._build_config()
        with torch.device("meta"):
            self.model = Flux2Transformer(self.f2_config)

    def _build_config(self, layout: Optional[Dict] = None) -> Flux2Config:
        """The published FLUX.2 [dev] layout, the `_tiny` test layout, or
        `layout` (what load_weights read from a checkpoint); [model]'s
        hidden_size, num_layers, num_single_layers, text_dim and
        latent_channels override it, as in the JAX pipeline."""
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype,
                                      remat=remat_spec(self.config), **block_kernel_kwargs(mc))
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        for knob in ("hidden_size", "num_layers", "num_single_layers", "text_dim",
                     "latent_channels"):
            if mc.get(knob) is not None:
                kwargs[knob] = int(mc[knob])
        if "latent_channels" in kwargs:
            kwargs.setdefault("in_channels", 4 * kwargs["latent_channels"])
            kwargs.setdefault("out_channels", 4 * kwargs["latent_channels"])
        kwargs.update(layout or {})
        if "in_channels" in kwargs:
            kwargs["latent_channels"] = kwargs["in_channels"] // 4
        if mc.get("_tiny", False):
            return Flux2Config.tiny(**kwargs)
        return Flux2Config(**kwargs)

    def init_params(self, generator: torch.Generator) -> None:
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    def _inputs(self, x_packed, embeds, t, h, w, n_images: int):
        cfg = self.f2_config
        b = x_packed.shape[0]
        n_axes = len(cfg.axes_dims_rope)
        ids = [flux2_latent_ids(h // 2, w // 2, cfg.ref_index_scale * i, n_axes, self.device)
               for i in range(n_images)]
        return dict(hidden_states=x_packed.to(cfg.dtype),
                    encoder_hidden_states=embeds.to(self.device, cfg.dtype),
                    timestep=t, img_ids=torch.cat(ids),
                    guidance=torch.ones((b,), dtype=torch.float32, device=self.device),
                    img_seq_len=(h // 2) * (w // 2) if n_images > 1 else None)

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 32, H, W] (or [B, 32, 1, H, W]), text_embeds_0
        [B, S, text_dim], optional mask [B, Hm, Wm] and control_latents (an
        edit: packed after the noisy image, the output cut to its rows).
        Guidance 1.0, as the JAX pipeline trains."""
        latents = batch["latents"].to(self.device, torch.float32)
        if latents.dim() == 5:
            latents = latents[:, :, 0]
        b, c, h, w = latents.shape
        mask = batch.get("mask")
        if mask is not None:
            mask = pack_latents(resize_mask_to_latents(mask.to(self.device), h, w, c))
        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator, quantile=timestep_quantile,
                                 image_seq_len=(h // 2) * (w // 2), device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1)
        x_t = pack_latents((1.0 - t_exp) * latents + t_exp * noise)
        n_images = 1
        control = batch.get("control_latents")
        if control is not None:
            control = control.to(self.device, torch.float32)
            if control.dim() == 5:
                control = control[:, :, 0]
            x_t = torch.cat([x_t, pack_latents(control)], dim=1)
            n_images = 2
        inputs = self._inputs(x_t, batch["text_embeds_0"], t, h, w, n_images)
        return inputs, pack_latents(noise - latents), mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, text_embeds_0, width: int, height: int, generator=None,
               num_steps: int = 20, guidance_scale: float = 1.0, control_latents=None,
               noise: Optional[torch.Tensor] = None, **_unused):
        """Euler flow sampling through the training forward: latents [B, 32,
        height/8, width/8] f32, model.shift as the sigmas'
        shift; control_latents condition an edit."""
        from ..training.sampling import euler_flow_sample

        b = text_embeds_0.shape[0]
        c = self.f2_config.in_channels // 4
        h, w = height // 8, width // 8
        ctrl = None if control_latents is None else pack_latents(
            control_latents.to(self.device, torch.float32))

        def vel(x, t):
            x = pack_latents(x)
            if ctrl is not None:
                x = torch.cat([x, ctrl], dim=1)
            out = self.forward(self._inputs(x, text_embeds_0, t, h, w, 1 if ctrl is None else 2))
            return unpack_latents(out.float(), h, w)

        return euler_flow_sample(vel, (b, c, h, w), generator, num_steps=num_steps,
                                 guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift"), noise=noise,
                                 device=self.device)

    # --- caching encoders ----------------------------------------------------

    def _load_vae(self):
        return self._load_generic_image_vae(self.f2_config.latent_channels)

    def get_call_vae_fn(self):
        """fn(pixels) -> {"latents": [B, 32, H/8, W/8]}: the 32-channel KL VAE
        of model.vae_path, normalised by its batch-norm statistics."""
        return self._generic_image_vae_fn(
            tiny_latent_channels=self.f2_config.latent_channels)

    def get_call_text_encoder_fns(self):
        """[fn]: captions -> {"text_embeds_0": [B, 512, text_dim] f32 CPU
        tensor}, unmasked at the full 512 tokens: the LLM of
        model.text_encoder_path (Mistral-3 for Dev, Qwen3 for Klein) with the
        hidden states flux2_text_layers picks stacked per token; under
        `_tiny`, the JAX hook's seeded draws (8 rows)."""
        from .text_encoders import seeded_draws

        mc = self.model_config
        cfg = self.f2_config
        if mc.get("_tiny", False):
            return [lambda caps: {"text_embeds_0": seeded_draws(
                caps, "", (TINY_TEXT_LENGTH, cfg.text_dim))}]
        from .llm_encoders import LLMTextEncoder

        path = mc["text_encoder_path"]
        hf_cfg = json.loads((Path(path) / "config.json").read_text())
        layers = flux2_text_layers(hf_cfg, cfg.text_dim)
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        enc = LLMTextEncoder(path, max_length=512, hidden_layers=layers,
                             tokenizer_path=mc.get("tokenizer_path"), dtype=te_dtype,
                             fp8=bool(mc.get("text_encoder_fp8", False)), device=self.device)

        def fn(captions):
            return {"text_embeds_0": enc.encode(captions, return_mask=False)}

        return [fn]

    # --- weights -------------------------------------------------------------

    def _keymap_config(self):
        return self.f2_config

    def keymap(self):
        """The BFL / ComfyUI flux2 keys (global `.lin` modulations,
        MLPEmbedder time and guidance, `txt_norm` where the layout has it);
        LoRA in the ComfyUI dialect (`diffusion_model.` prefix)."""
        from .keymaps import BlockGroup, KeyMap

        cfg = self.f2_config
        top_linears = {
            "img_in": "img_in", "txt_in": "txt_in",
            "time_in_1": "time_in.in_layer", "time_in_2": "time_in.out_layer",
            "double_stream_modulation_img": "double_stream_modulation_img.lin",
            "double_stream_modulation_txt": "double_stream_modulation_txt.lin",
            "single_stream_modulation": "single_stream_modulation.lin",
            "final_mod": "final_layer.adaLN_modulation.1", "final_linear": "final_layer.linear",
        }
        if cfg.guidance_embeds:
            top_linears.update(guidance_in_1="guidance_in.in_layer",
                               guidance_in_2="guidance_in.out_layer")
        double = {f"{s}_{ours}": f"{s}_{theirs}" for s in ("img", "txt") for ours, theirs in (
            ("attn_qkv", "attn.qkv"), ("attn_proj", "attn.proj"),
            ("mlp_fc1", "mlp.0"), ("mlp_fc2", "mlp.2"))}
        double_norms = {f"{s}_attn_{n}_norm": f"{s}_attn.norm.{full}_norm"
                        for s in ("img", "txt") for n, full in (("q", "query"), ("k", "key"))}
        return KeyMap(
            blocks=[
                BlockGroup("double_blocks", "double_blocks", "num_layers", linears=double,
                           norms=double_norms, norm_suffix="scale"),
                BlockGroup("single_blocks", "single_blocks", "num_single_layers",
                           linears={"linear1": "linear1", "linear2": "linear2"},
                           norms={"q_norm": "norm.query_norm", "k_norm": "norm.key_norm"},
                           norm_suffix="scale"),
            ],
            top_linears=top_linears,
            top_norms={"txt_norm": "txt_norm"} if cfg.txt_norm else {},
            top_norm_suffix="scale",
            lora_prefix="diffusion_model.",
        )

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The transformer of model.transformer_path (or ckpt_path) as a state
        dict of the port's names, the model rebuilt on the checkpoint's layout
        first; a layout field set in [model] that disagrees raises."""
        from .keymaps import (keymap_to_state_dict, layout_override, load_sd_for_pipeline,
                              strip_known_prefixes)

        sd = load_sd_for_pipeline(self)
        layout = layout_override(self.model_config, flux2_checkpoint_layout(
            strip_known_prefixes(sd, self.keymap())))
        if any(getattr(self.f2_config, k) != v for k, v in layout.items()):
            self.f2_config = self._build_config(layout)
            with torch.device("meta"):
                self.model = Flux2Transformer(self.f2_config)
        return keymap_to_state_dict(sd, self.keymap(), self.f2_config)

