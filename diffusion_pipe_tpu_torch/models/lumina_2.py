"""Lumina-Image-2.0 (NextDiT): the transformer and its pipeline, which
Z-Image (models/z_image.py) and OmniGen2 (models/omnigen2.py) build on.

Counterpart of diffusion_pipe_tpu/models/lumina_2.py. The joint [caption,
image] single stream: the caption's Gemma-2 features go through an RMS
norm and a linear, then the context refiner (masked, no adaLN); the
patchified latents through x_embedder (and, where the family has them, the
learned pad tokens up to a multiple of pad_tokens_multiple), then the
noise refiner (adaLN, unmasked); then the main blocks over [caption, image]
under the mask [cap_mask, ones]. RoPE has three axes: a caption row i sits
at (i + rope_cap_offset, 0, 0), an image token at (cap_len +
rope_cap_offset, row, col), a pad token at (0, 0, 0). The head: a
non-affine LayerNorm (eps 1e-6) in f32 scaled by 1 + adaLN, a linear and
the unpatchify, on the image tokens only.

A block has sandwich RMS norms (eps 1e-5) around the attention and the
SwiGLU, grouped-query attention with RMS-normed q and k and interleaved
RoPE, K and V repeated heads / kv_heads times as the JAX module repeats
them, and a 4-way adaLN (scale_msa, gate_msa, scale_mlp, gate_mlp) with
tanh gates, which applies SiLU to the timestep embedding itself: the
embedding goes into the blocks and the head as t_embedder_2 gives it, SiLU
applied once, inside each. Attention runs on K1-K3 at the family's head
dim: 96 for Lumina 2 (24 heads of 96 at width 2,304), 120 for OmniGen2,
128 for Z-Image.

Where the port departs from the JAX module, on purpose:
- the timestep is scaled by `time_scale`: 1 for Lumina 2, whose NextDiT
  embeds the raw t in [0, 1] (as diffusers' Lumina 2 pipeline does; the
  JAX module's own comment says so, yet it multiplies by 1,000 for every
  family), 1,000 for Z-Image and OmniGen2;
- the widths of the timestep MLP (time_mid_dim, adaln_dim) and of the
  SwiGLU (ffn_hidden_dim) may come from a checkpoint, whose layout
  (lumina2_checkpoint_layout) decides the model's; the JAX module fixes
  them at min(dim, 1024) and dim * 8 / 3;
- the adapter export covers the refiners' fused qkv too (the JAX KeyMap
  lists them among its top-level fused entries, which its export skips).

The block linears (q, k, v, out, w1, w2, w3) take the adapter, fp8 storage
and int8 compute; the modulations, embedders and head keep param_dtype.
With `remat` set each main block runs under remat_call (the JAX module
checkpoints the scanned main stack only).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common import dtype_from_string
from ..ops.attention import dot_product_attention
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .layers import (LoraDense, RMSNorm, adapter_kwargs, apply_rope, block_kernel_kwargs,
                     init_module_weights, layer_norm, remat_call, remat_spec, rope_frequencies,
                     sinusoidal_timestep_embedding)

TINY_TEXT_LENGTH = 8
# [model] knobs that set the transformer's sizes, as the JAX Z-Image reads them
SIZE_KNOBS = ("dim", "num_layers", "num_refiner_layers", "num_heads", "num_kv_heads", "cap_dim",
              "in_channels", "out_channels")


@dataclasses.dataclass(frozen=True)
class Lumina2Config:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    dim: int = 2304
    num_layers: int = 26
    num_refiner_layers: int = 2
    num_heads: int = 24
    num_kv_heads: int = 8
    cap_dim: int = 2304            # Gemma-2-2B's width
    axes_dims_rope: Tuple[int, ...] = (32, 32, 32)
    rope_theta: float = 10000.0
    rope_cap_offset: int = 0
    # learned image pad tokens up to this multiple (Z-Image); None: none
    pad_tokens_multiple: Optional[int] = None
    ffn_dim_multiplier: float = 8.0 / 3.0
    ffn_hidden_dim: Optional[int] = None  # else int(dim * ffn_dim_multiplier)
    adaln_dim: Optional[int] = None       # the timestep embedding's width, else min(dim, 1024)
    time_mid_dim: Optional[int] = None    # t_embedder_1's width, else the adaLN width
    time_scale: float = 1.0               # t in [0, 1] times this enters the sinusoid
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
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def ffn_hidden(self) -> int:
        return self.ffn_hidden_dim or int(self.dim * self.ffn_dim_multiplier)

    @property
    def adaln_width(self) -> int:
        return self.adaln_dim or min(self.dim, 1024)

    @property
    def time_mid_width(self) -> int:
        return self.time_mid_dim or self.adaln_width

    def dense(self, in_features: int, features: int) -> LoraDense:
        """A block linear: the adapter, fp8 storage and int8 compute."""
        return LoraDense(in_features, features, use_bias=False, dtype=self.dtype,
                         param_dtype=self.param_dtype, lora_rank=self.lora_rank,
                         lora_alpha=self.lora_alpha, lora_dropout=self.lora_dropout,
                         lora_dtype=self.lora_dtype, kernel_dtype=self.base_kernel_dtype,
                         int8_matmul=self.int8_matmul, lora_type=self.lora_type,
                         lokr_factor=self.lokr_factor, lokr_rank_dropout=self.lokr_rank_dropout)

    @staticmethod
    def tiny(**kw) -> "Lumina2Config":
        """The JAX Lumina2Config.tiny sizes (4 heads of 12, 2 kv heads)."""
        d = dict(dim=48, num_layers=2, num_refiner_layers=1, num_heads=4, num_kv_heads=2,
                 cap_dim=32, axes_dims_rope=(4, 4, 4), dtype=torch.float32,
                 param_dtype=torch.float32)
        d.update(kw)
        return Lumina2Config(**d)


class Lumina2Block(nn.Module):
    """A NextDiT block; use_adaln False for the context refiner."""

    def __init__(self, cfg: Lumina2Config, use_adaln: bool = True):
        super().__init__()
        self.cfg = cfg
        dim, hd, ffn = cfg.dim, cfg.head_dim, cfg.ffn_hidden
        self.attn_wq = cfg.dense(dim, cfg.num_heads * hd)
        self.attn_wk = cfg.dense(dim, cfg.num_kv_heads * hd)
        self.attn_wv = cfg.dense(dim, cfg.num_kv_heads * hd)
        self.attn_wo = cfg.dense(cfg.num_heads * hd, dim)
        self.ffn_w1 = cfg.dense(dim, ffn)
        self.ffn_w3 = cfg.dense(dim, ffn)
        self.ffn_w2 = cfg.dense(ffn, dim)
        for name in ("attention_norm1", "attention_norm2", "ffn_norm1", "ffn_norm2"):
            setattr(self, name, RMSNorm(dim, 1e-5, cfg.param_dtype))
        self.attn_q_norm = RMSNorm(hd, 1e-5, cfg.param_dtype)
        self.attn_k_norm = RMSNorm(hd, 1e-5, cfg.param_dtype)
        self.adaLN_modulation = (LoraDense(cfg.adaln_width, 4 * dim, dtype=cfg.dtype,
                                           param_dtype=cfg.param_dtype) if use_adaln else None)

    def forward(self, x, mask, cos, sin, temb=None):
        """x [B, S, dim]; mask [B, S] (nonzero = valid key) or None; cos, sin
        [S, head_dim / 2]; temb [B, adaLN width] (blocks with adaLN)."""
        cfg = self.cfg
        b, s, _ = x.shape
        heads, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        scale_msa = scale_mlp = gate_msa = gate_mlp = None
        if self.adaLN_modulation is not None:
            scale_msa, gate_msa, scale_mlp, gate_mlp = (
                self.adaLN_modulation(F.silu(temb))[:, None].chunk(4, dim=-1))
            scale_msa, scale_mlp = 1 + scale_msa, 1 + scale_mlp
            gate_msa, gate_mlp = torch.tanh(gate_msa), torch.tanh(gate_mlp)

        def scaled(y, scale):
            return y if scale is None else y * scale

        def gated(y, gate):
            return y if gate is None else gate * y

        y = scaled(self.attention_norm1(x), scale_msa)
        q = apply_rope(self.attn_q_norm(self.attn_wq(y).reshape(b, s, heads, hd)), cos, sin)
        k = apply_rope(self.attn_k_norm(self.attn_wk(y).reshape(b, s, kv, hd)), cos, sin)
        v = self.attn_wv(y).reshape(b, s, kv, hd)
        if heads != kv:
            k, v = (t.repeat_interleave(heads // kv, dim=2) for t in (k, v))
        y = self.attn_wo(dot_product_attention(q, k, v, mask).reshape(b, s, heads * hd))
        x = x + gated(self.attention_norm2(y), gate_msa)
        y = scaled(self.ffn_norm1(x), scale_mlp)
        y = self.ffn_w2(F.silu(self.ffn_w1(y)) * self.ffn_w3(y))
        return x + gated(self.ffn_norm2(y), gate_mlp)


def lumina2_rope_ids(cfg: Lumina2Config, cap_len: int, gh: int, gw: int,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(caption ids [cap_len, 3], image ids [gh * gw + pads, 3], pads): the
    caption's rows on axis 0 from rope_cap_offset, the image tokens at axis
    0 = cap_len + rope_cap_offset with their (row, col), the pad tokens up
    to pad_tokens_multiple at (0, 0, 0)."""
    off, img_len = cfg.rope_cap_offset, gh * gw
    ar = torch.arange(cap_len, device=device)
    cap = torch.stack([ar + off, torch.zeros_like(ar), torch.zeros_like(ar)], dim=-1)
    row = torch.arange(gh, device=device).repeat_interleave(gw)
    col = torch.arange(gw, device=device).repeat(gh)
    img = torch.stack([torch.full_like(row, cap_len + off), row, col], dim=-1)
    pads = (-img_len) % cfg.pad_tokens_multiple if cfg.pad_tokens_multiple else 0
    if pads:
        img = torch.cat([img, torch.zeros((pads, 3), dtype=img.dtype, device=device)])
    return cap, img, pads


class Lumina2Transformer(nn.Module):
    def __init__(self, cfg: Lumina2Config):
        super().__init__()
        if sum(cfg.axes_dims_rope) != cfg.head_dim:
            raise ValueError(f"RoPE axes {tuple(cfg.axes_dims_rope)} sum to "
                             f"{sum(cfg.axes_dims_rope)}, not the head dim {cfg.head_dim} "
                             f"(width {cfg.dim} over {cfg.num_heads} heads)")
        self.cfg = cfg
        dim, p = cfg.dim, cfg.patch_size
        dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.t_embedder_1 = LoraDense(256, cfg.time_mid_width, **dd)
        self.t_embedder_2 = LoraDense(cfg.time_mid_width, cfg.adaln_width, **dd)
        self.cap_embedder_norm = RMSNorm(cfg.cap_dim, 1e-5, cfg.param_dtype)
        self.cap_embedder = LoraDense(cfg.cap_dim, dim, **dd)
        self.x_embedder = LoraDense(p * p * cfg.in_channels, dim, **dd)
        if cfg.pad_tokens_multiple:
            # cap_pad_token is in the checkpoint; the caption pads are off
            # in the reference too
            self.x_pad_token = nn.Parameter(torch.empty(1, dim, dtype=cfg.param_dtype))
            self.cap_pad_token = nn.Parameter(torch.empty(1, dim, dtype=cfg.param_dtype))
        self.context_refiner = nn.ModuleList([Lumina2Block(cfg, use_adaln=False)
                                              for _ in range(cfg.num_refiner_layers)])
        self.noise_refiner = nn.ModuleList([Lumina2Block(cfg)
                                            for _ in range(cfg.num_refiner_layers)])
        self.layers = nn.ModuleList([Lumina2Block(cfg) for _ in range(cfg.num_layers)])
        self.final_adaLN = LoraDense(cfg.adaln_width, dim, **dd)
        self.final_linear = LoraDense(dim, p * p * cfg.out_channels, **dd)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The pad tokens: normal draws of std 0.02, drawn in f32."""
        if self.cfg.pad_tokens_multiple:
            for t in (self.x_pad_token, self.cap_pad_token):
                tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
                t.copy_(tmp.normal_(0.0, 0.02, generator=generator))

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(self, x, t, cap_feats, cap_mask):
        """x [B, C, H, W]; t [B] (1 - the noise level); cap_feats [B, Lc,
        cap_dim]; cap_mask [B, Lc] -> [B, C_out, H, W]."""
        cfg = self.cfg
        p, dt = cfg.patch_size, cfg.dtype
        b, c, hh, ww = x.shape
        gh, gw = hh // p, ww // p
        img_len, cap_len = gh * gw, cap_feats.shape[1]
        temb = sinusoidal_timestep_embedding(t.float() * cfg.time_scale, 256)
        temb = self.t_embedder_2(F.silu(self.t_embedder_1(temb.to(dt))))
        cap = self.cap_embedder(self.cap_embedder_norm(cap_feats.to(dt)))

        cap_ids, img_ids, pads = lumina2_rope_ids(cfg, cap_len, gh, gw, x.device)
        cap_cos, cap_sin = rope_frequencies(cap_ids, cfg.axes_dims_rope, cfg.rope_theta)
        img_cos, img_sin = rope_frequencies(img_ids, cfg.axes_dims_rope, cfg.rope_theta)
        for block in self.context_refiner:
            cap = block(cap, cap_mask, cap_cos, cap_sin)

        # a patch flattens as (row, col, channel)
        xi = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1).reshape(b, img_len, -1)
        xi = self.x_embedder(xi.to(dt))
        if pads:
            xi = torch.cat([xi, self.x_pad_token.to(xi.dtype).expand(b, pads, -1)], dim=1)
        for block in self.noise_refiner:
            xi = block(xi, None, img_cos, img_sin, temb)

        full = torch.cat([cap, xi], dim=1)
        full_mask = torch.cat([cap_mask.to(torch.int32),
                               torch.ones((b, img_len + pads), dtype=torch.int32,
                                          device=x.device)], dim=1)
        cos, sin = torch.cat([cap_cos, img_cos]), torch.cat([cap_sin, img_sin])
        for block in self.layers:
            full = self._run(block, full, full_mask, cos, sin, temb)

        out = full[:, cap_len:cap_len + img_len]
        mod = self.final_adaLN(F.silu(temb))
        xf = layer_norm(out.float(), eps=1e-6) * (1 + mod[:, None].float())
        out = self.final_linear(xf.to(dt)).reshape(b, gh, gw, p, p, cfg.out_channels)
        return out.permute(0, 5, 1, 3, 2, 4).reshape(b, cfg.out_channels, hh, ww)


# --- weights ---------------------------------------------------------------------

# NextDiT's (Lumina-Image-2.0's original and ComfyUI's) names of a block's
# parts, the JAX KeyMap's
NEXTDIT_LINEARS = {"attn_wo": "attention.out", "ffn_w1": "feed_forward.w1",
                   "ffn_w2": "feed_forward.w2", "ffn_w3": "feed_forward.w3"}
NEXTDIT_NORMS = {"attn_q_norm": "attention.q_norm", "attn_k_norm": "attention.k_norm",
                 "attention_norm1": "attention_norm1", "attention_norm2": "attention_norm2",
                 "ffn_norm1": "ffn_norm1", "ffn_norm2": "ffn_norm2"}
NEXTDIT_TOP = {"x_embedder": "x_embedder", "t_embedder_1": "t_embedder.mlp.0",
               "t_embedder_2": "t_embedder.mlp.2", "cap_embedder": "cap_embedder.1",
               "final_adaLN": "final_layer.adaLN_modulation.1",
               "final_linear": "final_layer.linear"}


def nextdit_keymap(cfg: Lumina2Config):
    """NextDiT (Lumina-Image-2.0, Z-Image) keys <-> the port's names: the
    fused attention.qkv with unequal q / k / v rows (heads, kv heads and kv
    heads times the head dim), the sandwich norms, the adaLN modulations of
    the main blocks and the noise refiner, the pad tokens where the model
    has them; LoRA in the ComfyUI dialect (`diffusion_model.` prefix)."""
    from .keymaps import BlockGroup, KeyMap

    hd = cfg.head_dim
    fused = {"attention.qkv": (("attn_wq", cfg.num_heads * hd), ("attn_wk", cfg.num_kv_heads * hd),
                               ("attn_wv", cfg.num_kv_heads * hd))}
    ada = {**NEXTDIT_LINEARS, "adaLN_modulation": "adaLN_modulation.1"}

    def group(name, count, linears):
        return BlockGroup(name, name, count, linears=linears, norms=NEXTDIT_NORMS, fused=fused)

    pads = {"x_pad_token": "x_pad_token", "cap_pad_token": "cap_pad_token"}
    return KeyMap(
        blocks=[group("layers", "num_layers", ada),
                group("context_refiner", "num_refiner_layers", NEXTDIT_LINEARS),
                group("noise_refiner", "num_refiner_layers", ada)],
        top_linears=NEXTDIT_TOP, top_norms={"cap_embedder_norm": "cap_embedder.0"},
        top_raw=pads if cfg.pad_tokens_multiple else {}, lora_prefix="diffusion_model.")


def lumina2_checkpoint_layout(sd, km, pad_tokens_multiple: int = 32) -> Dict[str, Any]:
    """What a (prefix-stripped) checkpoint in km's names holds: the width
    (x_embedder's rows), the head dim (the q norm's length), the heads
    (width over head dim), the kv heads (k's rows, or the fused qkv's rows
    past q's), the main and refiner block counts, the caption width, the
    timestep MLP's widths (t_embedder_1's and t_embedder_2's rows; the
    latter must be the adaLN modulations' columns), the SwiGLU's width,
    the latent channels, and whether the pad tokens are there (then
    pad_tokens_multiple, else None). A key the layout needs and sd lacks,
    or a disagreement inside the checkpoint, raises KeyError naming it."""
    from .keymaps import count_blocks

    main = next(bg for bg in km.blocks if bg.flax_key == "layers")
    pre = f"{main.prefix}.0."
    top = km.top_linears

    def shape(key):
        if key not in sd:
            raise KeyError(f"the checkpoint lacks {key}, which its layout is read from")
        return tuple(sd[key].shape)

    dim, patch_in = shape(f"{top['x_embedder']}.weight")
    hd = shape(f"{pre}{main.norms['attn_q_norm']}.weight")[0]
    if "attn_wk" in main.linears:
        kv_rows = shape(f"{pre}{main.linears['attn_wk']}.weight")[0]
    else:
        qkv = next(k for k, parts in main.fused.items() if any(n == "attn_wk" for n, _ in parts))
        kv_rows = (shape(f"{pre}{qkv}.weight")[0] - dim) // 2
    adaln = shape(f"{top['t_embedder_2']}.weight")[0]
    mod_key = f"{pre}{main.linears['adaLN_modulation']}.weight"
    if shape(mod_key)[1] != adaln:
        raise KeyError(f"{top['t_embedder_2']}.weight gives a {adaln}-wide timestep embedding "
                       f"but {mod_key} takes {shape(mod_key)[1]}")
    refiners = {bg.prefix: count_blocks(sd, bg.prefix) for bg in km.blocks if bg is not main}
    if len(set(refiners.values())) != 1:
        raise KeyError(f"refiner block counts differ: {refiners}")
    p2 = Lumina2Config.patch_size ** 2
    return dict(dim=dim, num_heads=dim // hd, num_kv_heads=kv_rows // hd,
                num_layers=count_blocks(sd, main.prefix),
                num_refiner_layers=next(iter(refiners.values())),
                cap_dim=shape(f"{km.top_norms['cap_embedder_norm']}.weight")[0],
                adaln_dim=adaln, time_mid_dim=shape(f"{top['t_embedder_1']}.weight")[0],
                ffn_hidden_dim=shape(f"{pre}{main.linears['ffn_w1']}.weight")[0],
                in_channels=patch_in // p2,
                out_channels=shape(f"{top['final_linear']}.weight")[0] // p2,
                pad_tokens_multiple=pad_tokens_multiple if "x_pad_token" in sd else None)


@register_model("lumina_2", "lumina2")
class Lumina2Pipeline(BasePipeline):
    name = "lumina_2"
    # the names of the cached caption features and their mask
    text_keys = ("cap_feats", "cap_mask")

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        mc = self.model_config
        # lumina_shift is the resolution-dependent (Flux) shift
        tmc = {**mc, "flux_shift": mc.get("flux_shift", bool(mc.get("lumina_shift", False)))}
        self.tdist = TimestepDistribution.from_model_config(tmc)
        self.lumina_config = self._build_config()
        with torch.device("meta"):
            self.model = Lumina2Transformer(self.lumina_config)

    # --- the family's layout ------------------------------------------------

    def family_kwargs(self) -> Dict[str, Any]:
        """Config fields of the family at every size, `_tiny` included."""
        return dict(time_scale=1.0)

    def published_layout(self) -> Dict[str, Any]:
        """The released model's sizes, taken when no checkpoint says
        otherwise (Lumina-Image-2.0: Lumina2Config's defaults)."""
        return {}

    def _build_config(self, layout: Optional[Dict] = None) -> Lumina2Config:
        """The published layout (or the `_tiny` test sizes), the [model]
        size knobs over it, and `layout` (read from a checkpoint) over
        those."""
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype,
                                      remat=remat_spec(self.config), **block_kernel_kwargs(mc))
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        kwargs.update(self.family_kwargs())
        kwargs.update({k: int(mc[k]) for k in SIZE_KNOBS if mc.get(k) is not None})
        kwargs.update(layout or {})
        if mc.get("_tiny", False):
            return Lumina2Config.tiny(**kwargs)
        return Lumina2Config(**{**self.published_layout(), **kwargs})

    def init_params(self, generator: torch.Generator) -> None:
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    # --- training -----------------------------------------------------------

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 16, H, W] (or [B, 16, 1, H, W]), the caption
        features and mask under the family's text_keys, optional mask [B,
        Hm, Wm] (nearest-resized to [B, 1, H, W]). x_t = (1 - t) latents +
        t noise goes in with model time 1 - t, and the target is latents -
        noise: the signs flipped against Flux, as NextDiT is trained."""
        latents = batch["latents"].to(self.device, torch.float32)
        if latents.dim() == 5:
            latents = latents[:, :, 0]
        b, _, h, w = latents.shape
        mask = batch.get("mask")
        if mask is not None:
            mask = F.interpolate(mask.to(self.device).float()[:, None], size=(h, w),
                                 mode="nearest-exact")
        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator, quantile=timestep_quantile,
                                 image_seq_len=(h // 2) * (w // 2), device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1)
        feats, cap_mask = (batch[k] for k in self.text_keys)
        inputs = dict(x=(1.0 - t_exp) * latents + t_exp * noise, t=1.0 - t,
                      cap_feats=feats.to(self.device),
                      cap_mask=cap_mask.to(self.device).reshape(b, -1))
        return inputs, latents - noise, mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, noise: Optional[torch.Tensor] = None, **embeds):
        """Euler flow sampling through the training forward: latents [B, 16,
        height/8, width/8] f32, model.shift as the sigmas' shift. The model
        predicts latents - noise at time 1 - t, so the sampler's velocity is
        its output negated. The caption features come under any of the
        three families' names."""
        from ..training.sampling import euler_flow_sample

        cfg = self.lumina_config
        names = (("cap_feats", "cap_mask"), ("prompt_embeds", "prompt_attention_mask"),
                 ("text_embeds_0", "attention_mask_0"))
        feats, cap_mask = next((embeds[f], embeds.get(m)) for f, m in names if f in embeds)
        b = feats.shape[0]
        if cap_mask is None:
            cap_mask = torch.ones(feats.shape[:2], dtype=torch.int32, device=feats.device)

        def vel(x, t):
            return -self.forward(dict(x=x.to(cfg.dtype), t=1.0 - t, cap_feats=feats,
                                      cap_mask=cap_mask)).float()

        return euler_flow_sample(vel, (b, cfg.in_channels, height // 8, width // 8), generator,
                                 num_steps=num_steps, guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift"), noise=noise,
                                 device=self.device)

    # --- caching encoders ----------------------------------------------------

    def _load_vae(self):
        from .flux import FluxPipeline

        return FluxPipeline._load_vae(self)

    def get_call_vae_fn(self):
        """fn(pixels) -> {"latents": [B, 16, H/8, W/8]}: the Flux VAE, which
        all three families use, loaded as the port's Flux pipeline loads it."""
        from .flux import FluxPipeline

        return FluxPipeline.get_call_vae_fn(self)

    # the text tower's hidden state that feeds the model (-2: the
    # penultimate layer's, as transformers counts them)
    text_hidden_layer = -2

    def _max_length(self) -> int:
        return 256

    def get_call_text_encoder_fns(self):
        """[fn]: captions -> {features [B, L, cap_dim] f32, mask [B, L]
        int32} under text_keys: the decoder LM of model.text_encoder_path
        (Lumina 2: Gemma-2-2B, right-padded to 256, hidden_states[-2]);
        under `_tiny`, the JAX hook's seeded draws."""
        from .llm_encoders import LLMTextEncoder
        from .text_encoders import seeded_caption_draws

        mc = self.model_config
        feats_key, mask_key = self.text_keys
        if mc.get("_tiny", False):
            def tiny(captions):
                feats, mask = seeded_caption_draws(captions, TINY_TEXT_LENGTH,
                                                   self.lumina_config.cap_dim)
                return {feats_key: feats, mask_key: mask}

            return [tiny]
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        enc = LLMTextEncoder(mc["text_encoder_path"], max_length=self._max_length(),
                             hidden_layer=self.text_hidden_layer, tokenizer_path=mc.get("tokenizer_path"),
                             dtype=te_dtype, device=self.device)

        def fn(captions):
            h, m = enc.encode(captions)
            return {feats_key: h, mask_key: m.to(torch.int32)}

        return [fn]

    # --- weights -------------------------------------------------------------

    def _keymap_config(self):
        return self.lumina_config

    def keymap(self):
        return nextdit_keymap(self.lumina_config)

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The transformer the model config names (ComfyUI fp8 dequantized,
        model.merge_adapters fused in) as the port's state dict, the model
        rebuilt on the checkpoint's layout first (a [model] size that
        disagrees with it raises)."""
        from .keymaps import (keymap_to_state_dict, layout_override, load_sd_for_pipeline,
                              strip_known_prefixes)

        mc = self.model_config
        sd = strip_known_prefixes(load_sd_for_pipeline(self), self.keymap())
        layout = lumina2_checkpoint_layout(sd, self.keymap(),
                                           self.lumina_config.pad_tokens_multiple or 32)
        pads = mc.get("pad_tokens_multiple")  # 0 turns the pad tokens off
        if pads is not None and bool(pads) != (layout["pad_tokens_multiple"] is not None):
            raise KeyError(f"model.pad_tokens_multiple = {pads!r} but the checkpoint "
                           f"{'holds' if pads == 0 else 'lacks'} x_pad_token")
        layout = layout_override({k: v for k, v in mc.items() if k != "pad_tokens_multiple"},
                                 layout)
        if any(getattr(self.lumina_config, k) != v for k, v in layout.items()):
            self.lumina_config = self._build_config(layout)
            with torch.device("meta"):
                self.model = Lumina2Transformer(self.lumina_config)
        return keymap_to_state_dict(sd, self.keymap(), self.lumina_config)
