"""HiDream-I1: the MoE transformer and its pipeline.

Counterpart of diffusion_pipe_tpu/models/hidream.py. 16 dual-stream and 32
single-stream blocks at 2,560 wide, 20 heads of 128, each with a
mixture-of-experts feed-forward on the image stream: a shared SwiGLU expert
that always runs, and 4 routed SwiGLU experts gated by a bias-free router
in f32 (softmax, then the top 2 weights, not renormalised, scattered back
into a mixture over the 4). Every routed expert is computed for every token
and mixed by its gate, as the JAX module computes it; a routed grouped GEMM
is speed work for later.

A block takes the timestep embedding as the embedders give it and applies
SiLU to it once, inside its fused adaLN (12-way in a double block: image
then text; 6-way in a single block); the head does the same. Full-width RMS
q / k norms come before the head split, then interleaved RoPE and the joint
attention over [image, text] on K1-K3 at D 128. The text stream takes each
block's own Llama-3.1 state: block i appends the projection of Llama layer
llama_layers[i] (a bias-free linear a block, caption_projection.{i}) to the
carried text, and keeps the carry's rows after it. The text rows' RoPE ids
are zero.

Where the port departs from the JAX module, by the published
HiDreamImageTransformer2DModel (hi_diffusers' and diffusers'), as the
ROADMAP's section C records them (readings to check against a checkpoint):
- the carried text stream starts as [T5, the last block's Llama state], not
  T5 alone (published_carry): at 1024 px the joint sequence is 4,096 + 128
  + 128 + 128 = 4,480 rows;
- llama_layers defaults to the published list, layers 0..31 and then 31
  for the last 16 blocks ("published": block i takes min(i, L - 1) of the L
  cached layers); the JAX module cycles i % L ("cycle");
- RoPE axes (64, 32, 32), not (32, 48, 48); axes that do not sum to the
  head dim raise;
- every routed expert's w1 / w2 / w3 is an adapted linear of its own (LoRA
  and LoKr), as the reference adapts every Linear of its target blocks;
  the JAX experts are raw parameters without an adapter. The router has
  none in either. The experts keep fp8 storage and compute without int8,
  as the JAX einsums do.
interop.hidream_config gives the JAX module's form of all three readings.

The pipeline: rectified flow with t scaled by 1,000 and the target
sign-flipped (latents - noise), Flux's 2 x 2 packing and latent ids, the
Flux VAE, pooled CLIP-L + CLIP-bigG (2,048), T5 at 128 tokens and
Llama-3.1-8B's states of every layer [B, 32, 128, 4,096], all cached.
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
from .flux import latent_image_ids, pack_latents, resize_mask_to_latents, unpack_latents
from .layers import (LoraDense, RMSNorm, adapter_kwargs, apply_rope, block_kernel_kwargs,
                     init_module_weights, layer_norm, remat_call, remat_spec, rope_frequencies,
                     sinusoidal_timestep_embedding)

TINY_TEXT_LENGTH = 8
TINY_LLAMA_LAYERS = 2
# [model] knobs that set the transformer's sizes
SIZE_KNOBS = ("num_double_layers", "num_single_layers", "hidden_size", "num_heads",
              "num_routed_experts", "expert_hidden", "shared_hidden",
              "t5_dim", "llama_dim", "pooled_dim")


def swiglu_hidden(dim: int, mlp_ratio: float, multiple_of: int = 256) -> int:
    """FeedForwardSwiGLU's hidden width: int(2/3 * dim * ratio) rounded up
    to `multiple_of` (6,912 for the experts and ff_t at 2,560 and ratio 4,
    3,584 for the shared expert at ratio 2)."""
    h = int(2 * int(dim * mlp_ratio) / 3)
    return multiple_of * ((h + multiple_of - 1) // multiple_of)


@dataclasses.dataclass(frozen=True)
class HiDreamConfig:
    in_channels: int = 64          # 16 latent channels packed 2 x 2
    out_channels: int = 64
    hidden_size: int = 2560
    num_heads: int = 20
    num_double_layers: int = 16
    num_single_layers: int = 32
    t5_dim: int = 4096
    llama_dim: int = 4096
    pooled_dim: int = 2048         # CLIP-L (768) + CLIP-bigG (1,280)
    num_routed_experts: int = 4
    num_activated_experts: int = 2
    mlp_ratio: float = 4.0
    expert_hidden: Optional[int] = None   # the experts' and ff_t's width, else swiglu_hidden
    shared_hidden: Optional[int] = None   # the shared expert's, else at half the ratio
    # the Llama layer of each block: a tuple of indices into the cached
    # layers, "published" (block i takes min(i, L - 1)) or "cycle" (i % L,
    # the JAX module's default)
    llama_layers: Any = "published"
    published_carry: bool = True   # the text carry starts as [T5, the last block's state]
    axes_dims_rope: Tuple[int, ...] = (64, 32, 32)
    rope_theta: float = 10000.0
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
        return self.hidden_size // self.num_heads

    @property
    def num_blocks(self) -> int:
        return self.num_double_layers + self.num_single_layers

    @property
    def ff_hidden(self) -> int:
        return self.expert_hidden or swiglu_hidden(self.hidden_size, self.mlp_ratio)

    @property
    def shared_ff_hidden(self) -> int:
        return self.shared_hidden or swiglu_hidden(self.hidden_size, self.mlp_ratio / 2)

    def block_layers(self, n_layers: int) -> Tuple[int, ...]:
        """The cached Llama layer of each block, of n_layers cached."""
        if self.llama_layers == "published":
            return tuple(min(i, n_layers - 1) for i in range(self.num_blocks))
        if self.llama_layers == "cycle":
            return tuple(i % n_layers for i in range(self.num_blocks))
        return tuple(self.llama_layers)

    def dense(self, in_features: int, features: int, bias: bool = True,
              int8: bool = True) -> LoraDense:
        """A block linear: the adapter and fp8 storage, int8 compute unless
        int8 is False (the experts)."""
        return LoraDense(in_features, features, use_bias=bias, dtype=self.dtype,
                         param_dtype=self.param_dtype, lora_rank=self.lora_rank,
                         lora_alpha=self.lora_alpha, lora_dropout=self.lora_dropout,
                         lora_dtype=self.lora_dtype, kernel_dtype=self.base_kernel_dtype,
                         int8_matmul=self.int8_matmul if int8 else False,
                         lora_type=self.lora_type, lokr_factor=self.lokr_factor,
                         lokr_rank_dropout=self.lokr_rank_dropout)

    @staticmethod
    def tiny(**kw) -> "HiDreamConfig":
        """The JAX HiDreamConfig.tiny sizes (2 + 2 blocks, 2 heads of 16), the
        published RoPE axes scaled to head dim 16."""
        d = dict(hidden_size=32, num_heads=2, num_double_layers=2, num_single_layers=2,
                 t5_dim=16, llama_dim=24, pooled_dim=16, axes_dims_rope=(8, 4, 4),
                 dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return HiDreamConfig(**d)


class SwiGLU(nn.Module):
    """w2(silu(w1 x) * w3 x), bias-free."""

    def __init__(self, w1: LoraDense, w3: LoraDense, w2: LoraDense):
        super().__init__()
        self.w1, self.w3, self.w2 = w1, w3, w2

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def _swiglu(cfg: HiDreamConfig, hidden: int, int8: bool = True) -> SwiGLU:
    dim = cfg.hidden_size
    return SwiGLU(cfg.dense(dim, hidden, False, int8), cfg.dense(dim, hidden, False, int8),
                  cfg.dense(hidden, dim, False, int8))


class MoEFeedForward(nn.Module):
    """The shared SwiGLU expert plus the routed ones, mixed by the router's
    top-k softmax weights (hi_diffusers MOEFeedForwardSwiGLU: `shared_experts`,
    `experts.{j}`, the bias-free `gate`). Dense: every expert runs on every
    token."""

    def __init__(self, cfg: HiDreamConfig):
        super().__init__()
        self.cfg = cfg
        self.shared = _swiglu(cfg, cfg.shared_ff_hidden)
        self.gate = LoraDense(cfg.hidden_size, cfg.num_routed_experts, use_bias=False,
                              dtype=torch.float32, param_dtype=cfg.param_dtype)
        self.experts = nn.ModuleList([_swiglu(cfg, cfg.ff_hidden, int8=False)
                                      for _ in range(cfg.num_routed_experts)])

    def gate_weights(self, x: torch.Tensor) -> torch.Tensor:
        """[..., E] f32: the top-k softmax probabilities in place, 0 elsewhere."""
        probs = torch.softmax(self.gate(x.float()), dim=-1)
        top_v, top_i = torch.topk(probs, self.cfg.num_activated_experts, dim=-1)
        return torch.zeros_like(probs).scatter(-1, top_i, top_v)

    def forward(self, x):
        gate = self.gate_weights(x).to(self.cfg.dtype)
        routed = sum(gate[..., j:j + 1] * expert(x) for j, expert in enumerate(self.experts))
        return self.shared(x) + routed


def _modulated(x, shift, scale):
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


class HiDreamDoubleBlock(nn.Module):
    """hi_diffusers HiDreamImageTransformerBlock: the image stream and the
    text stream [carry, this block's Llama state], joint attention, the MoE
    on the image and ff_t on the text; the carry keeps its own rows."""

    def __init__(self, cfg: HiDreamConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.adaLN = cfg.dense(dim, 12 * dim)
        for s in ("", "_t"):
            for part in ("q", "k", "v", "out"):
                setattr(self, f"attn_to_{part}{s}", cfg.dense(dim, dim))
            setattr(self, f"attn_q_norm{s}", RMSNorm(dim, 1e-6, cfg.param_dtype))
            setattr(self, f"attn_k_norm{s}", RMSNorm(dim, 1e-6, cfg.param_dtype))
        self.ff_i = MoEFeedForward(cfg)
        self.ff_t = _swiglu(cfg, cfg.ff_hidden)

    def _qkv(self, x, s):
        b, n, _ = x.shape
        heads, hd = self.cfg.num_heads, self.cfg.head_dim
        q = getattr(self, f"attn_q_norm{s}")(getattr(self, f"attn_to_q{s}")(x))
        k = getattr(self, f"attn_k_norm{s}")(getattr(self, f"attn_to_k{s}")(x))
        v = getattr(self, f"attn_to_v{s}")(x)
        return (t.reshape(b, n, heads, hd) for t in (q, k, v))

    def forward(self, img, txt, temb, llama_ctx, cos, sin):
        """img [B, Si, dim]; txt [B, St_keep, dim] (the carry); llama_ctx [B,
        Sl, dim]; cos, sin [Si + St_keep + Sl, head_dim / 2]."""
        b, si, dim = img.shape
        keep = txt.shape[1]
        txt = torch.cat([txt, llama_ctx.to(txt.dtype)], dim=1)
        i1, i2, i3, i4, i5, i6, t1, t2, t3, t4, t5, t6 = self.adaLN(F.silu(temb)).chunk(12, -1)
        iq, ik, iv = self._qkv(_modulated(img, i1, i2), "")
        tq, tk, tv = self._qkv(_modulated(txt, t1, t2), "_t")
        q = apply_rope(torch.cat([iq, tq], dim=1), cos, sin)
        k = apply_rope(torch.cat([ik, tk], dim=1), cos, sin)
        attn = dot_product_attention(q, k, torch.cat([iv, tv], dim=1)).reshape(b, -1, dim)
        img = img + i3[:, None] * self.attn_to_out(attn[:, :si])
        txt = txt + t3[:, None] * self.attn_to_out_t(attn[:, si:])
        img = img + i6[:, None] * self.ff_i(_modulated(img, i4, i5))
        txt = txt + t6[:, None] * self.ff_t(_modulated(txt, t4, t5))
        return img, txt[:, :keep]


class HiDreamSingleBlock(nn.Module):
    """hi_diffusers HiDreamImageSingleTransformerBlock: this block's Llama
    state appended to [image, text], attended over, the MoE, then dropped."""

    def __init__(self, cfg: HiDreamConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.adaLN = cfg.dense(dim, 6 * dim)
        for part in ("q", "k", "v", "out"):
            setattr(self, f"attn_to_{part}", cfg.dense(dim, dim))
        self.attn_q_norm = RMSNorm(dim, 1e-6, cfg.param_dtype)
        self.attn_k_norm = RMSNorm(dim, 1e-6, cfg.param_dtype)
        self.ff_i = MoEFeedForward(cfg)

    def forward(self, x, temb, llama_ctx, cos, sin):
        cfg = self.cfg
        keep = x.shape[1]
        x = torch.cat([x, llama_ctx.to(x.dtype)], dim=1)
        b, s, dim = x.shape
        m1, m2, m3, m4, m5, m6 = self.adaLN(F.silu(temb)).chunk(6, -1)
        y = _modulated(x, m1, m2)
        q = self.attn_q_norm(self.attn_to_q(y)).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = self.attn_k_norm(self.attn_to_k(y)).reshape(b, s, cfg.num_heads, cfg.head_dim)
        v = self.attn_to_v(y).reshape(b, s, cfg.num_heads, cfg.head_dim)
        attn = dot_product_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
        x = x + m3[:, None] * self.attn_to_out(attn.reshape(b, s, dim))
        x = x + m6[:, None] * self.ff_i(_modulated(x, m4, m5))
        return x[:, :keep]


class HiDreamTransformer(nn.Module):
    def __init__(self, cfg: HiDreamConfig):
        super().__init__()
        if sum(cfg.axes_dims_rope) != cfg.head_dim:
            raise ValueError(f"RoPE axes {tuple(cfg.axes_dims_rope)} sum to "
                             f"{sum(cfg.axes_dims_rope)}, not the head dim {cfg.head_dim} "
                             f"(width {cfg.hidden_size} over {cfg.num_heads} heads)")
        self.cfg = cfg
        dim = cfg.hidden_size
        dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.x_embedder = LoraDense(cfg.in_channels, dim, **dd)
        self.t_embed_1 = LoraDense(256, dim, **dd)
        self.t_embed_2 = LoraDense(dim, dim, **dd)
        self.p_embed_1 = LoraDense(cfg.pooled_dim, dim, **dd)
        self.p_embed_2 = LoraDense(dim, dim, **dd)
        self.t5_projection = LoraDense(cfg.t5_dim, dim, use_bias=False, **dd)
        self.caption_projection = nn.ModuleList([
            LoraDense(cfg.llama_dim, dim, use_bias=False, **dd) for _ in range(cfg.num_blocks)])
        self.double_blocks = nn.ModuleList([HiDreamDoubleBlock(cfg)
                                            for _ in range(cfg.num_double_layers)])
        self.single_blocks = nn.ModuleList([HiDreamSingleBlock(cfg)
                                            for _ in range(cfg.num_single_layers)])
        self.final_mod = LoraDense(dim, 2 * dim, **dd)
        self.proj_out = LoraDense(dim, cfg.out_channels, **dd)

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(self, x_tokens, img_ids, timesteps, pooled, t5_embeds, llama_embeds,
                img_seq_len: Optional[int] = None):
        """x_tokens [B, Si, 64]; img_ids [Si, 3]; timesteps [B] (t x 1,000);
        pooled [B, 2,048]; t5_embeds [B, St5, 4,096]; llama_embeds [B, L,
        Sl, 4,096], every cached Llama layer -> [B, Si, 64]."""
        cfg = self.cfg
        dt = cfg.dtype
        img = self.x_embedder(x_tokens.to(dt))
        temb = self.t_embed_2(F.silu(self.t_embed_1(
            sinusoidal_timestep_embedding(timesteps.float(), 256).to(dt))))
        temb = temb + self.p_embed_2(F.silu(self.p_embed_1(pooled.to(dt))))
        txt = self.t5_projection(t5_embeds.to(dt))
        layers = cfg.block_layers(llama_embeds.shape[1])
        llama = [proj(llama_embeds[:, layers[i]].to(dt))
                 for i, proj in enumerate(self.caption_projection)]
        if cfg.published_carry:
            txt = torch.cat([txt, llama[-1]], dim=1)
        rows = img.shape[1] + txt.shape[1] + llama[0].shape[1]
        ids = torch.cat([img_ids.float(), torch.zeros((rows - img.shape[1], 3),
                                                      device=img_ids.device)])
        cos, sin = rope_frequencies(ids, cfg.axes_dims_rope, cfg.rope_theta)
        for i, block in enumerate(self.double_blocks):
            img, txt = self._run(block, img, txt, temb, llama[i], cos, sin)
        x = torch.cat([img, txt], dim=1)
        for i, block in enumerate(self.single_blocks):
            x = self._run(block, x, temb, llama[cfg.num_double_layers + i], cos, sin)
        out = x[:, :img.shape[1]]
        if img_seq_len is not None:
            out = out[:, :img_seq_len]
        shift, scale = self.final_mod(F.silu(temb)).chunk(2, -1)
        return self.proj_out(_modulated(out, shift, scale))


# --- weights ---------------------------------------------------------------------

def _attn_names(suffix: str):
    lin = {f"attn_to_{p}{suffix}": f"block.attn1.to_{p}{suffix}" for p in ("q", "k", "v", "out")}
    norms = {f"attn_{p}_norm{suffix}": f"block.attn1.{p}_rms_norm{suffix}" for p in ("q", "k")}
    return lin, norms


def _moe_names(cfg: HiDreamConfig):
    names = {f"ff_i.shared.{w}": f"block.ff_i.shared_experts.{w}" for w in ("w1", "w2", "w3")}
    names["ff_i.gate"] = "block.ff_i.gate"
    for j in range(cfg.num_routed_experts):
        names.update({f"ff_i.experts.{j}.{w}": f"block.ff_i.experts.{j}.{w}"
                      for w in ("w1", "w2", "w3")})
    return names


def hidream_keymap(cfg: HiDreamConfig):
    """hi_diffusers HiDreamImageTransformer2DModel keys <-> the port's names:
    `double_stream_blocks.{i}.block.*` and `single_stream_blocks.{i}.block.*`,
    the experts `ff_i.experts.{j}.w1 / w2 / w3`, the shared expert
    `ff_i.shared_experts.*`, the router `ff_i.gate`, the caption projections
    `caption_projection.{n}.linear` with T5's last; LoRA in the ComfyUI
    dialect (`diffusion_model.` prefix), the experts' factors included."""
    from .keymaps import BlockGroup, KeyMap

    d_lin, d_norms = _attn_names("")
    t_lin, t_norms = _attn_names("_t")
    moe = _moe_names(cfg)
    ada = {"adaLN": "block.adaLN_modulation.1"}
    ff_t = {f"ff_t.{w}": f"block.ff_t.{w}" for w in ("w1", "w2", "w3")}
    nb = cfg.num_blocks
    return KeyMap(
        blocks=[BlockGroup("double_blocks", "double_stream_blocks", "num_double_layers",
                           linears={**d_lin, **t_lin, **moe, **ada, **ff_t},
                           norms={**d_norms, **t_norms}),
                BlockGroup("single_blocks", "single_stream_blocks", "num_single_layers",
                           linears={**d_lin, **moe, **ada}, norms=d_norms)],
        top_linears={"x_embedder": "x_embedder.proj",
                     "t_embed_1": "t_embedder.timestep_embedder.linear_1",
                     "t_embed_2": "t_embedder.timestep_embedder.linear_2",
                     "p_embed_1": "p_embedder.pooled_embedder.linear_1",
                     "p_embed_2": "p_embedder.pooled_embedder.linear_2",
                     "t5_projection": f"caption_projection.{nb}.linear",
                     **{f"caption_projection.{i}": f"caption_projection.{i}.linear"
                        for i in range(nb)},
                     "final_mod": "final_layer.adaLN_modulation.1",
                     "proj_out": "final_layer.linear"},
        lora_prefix="diffusion_model.")


def hidream_checkpoint_layout(sd, head_dim: int = 128) -> Dict[str, Any]:
    """What a (prefix-stripped) HiDream checkpoint holds: the double and
    single block counts, the width (x_embedder's rows; heads = width /
    head_dim), the expert count and width, the shared expert's width, the
    T5, Llama and pooled widths; the caption projections must number the
    blocks plus one (T5's), and the single blocks' experts and ff_t must
    agree with the double blocks'. A key the layout needs and sd lacks, or a
    disagreement inside the checkpoint, raises KeyError naming it."""
    from .keymaps import count_blocks

    def shape(key):
        if key not in sd:
            raise KeyError(f"the checkpoint lacks {key}, which its layout is read from")
        return tuple(sd[key].shape)

    n_double = count_blocks(sd, "double_stream_blocks")
    n_single = count_blocks(sd, "single_stream_blocks")
    dim, in_ch = shape("x_embedder.proj.weight")
    layout = dict(num_double_layers=n_double, num_single_layers=n_single, hidden_size=dim,
                  num_heads=dim // head_dim, in_channels=in_ch,
                  out_channels=shape("final_layer.linear.weight")[0],
                  pooled_dim=shape("p_embedder.pooled_embedder.linear_1.weight")[1])
    widths = {}
    for group, n in (("double_stream_blocks", n_double), ("single_stream_blocks", n_single)):
        if not n:
            continue
        pre = f"{group}.0.block.ff_i."
        widths[group] = dict(
            num_routed_experts=count_blocks(sd, pre + "experts"),
            expert_hidden=shape(pre + "experts.0.w1.weight")[0],
            shared_hidden=shape(pre + "shared_experts.w1.weight")[0])
    if len({tuple(sorted(w.items())) for w in widths.values()}) > 1:
        raise KeyError(f"the double and single blocks' experts differ: {widths}")
    layout.update(next(iter(widths.values()), {}))
    if n_double and shape("double_stream_blocks.0.block.ff_t.w1.weight")[0] != layout[
            "expert_hidden"]:
        raise KeyError("double_stream_blocks.0.block.ff_t.w1 is not as wide as the experts")
    n_caption = count_blocks(sd, "caption_projection")
    if n_caption != n_double + n_single + 1:
        raise KeyError(f"{n_caption} caption projections for {n_double} + {n_single} blocks "
                       "(one a block and T5's)")
    layout["llama_dim"] = shape("caption_projection.0.linear.weight")[1]
    layout["t5_dim"] = shape(f"caption_projection.{n_caption - 1}.linear.weight")[1]
    return layout


@register_model("hidream")
class HiDreamPipeline(BasePipeline):
    name = "hidream"
    # the cached text embeddings (the JAX package's names, so caches cross)
    text_keys = ("t5_embeds", "pooled", "llama_embeds")

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.hd_config = self._build_config()
        with torch.device("meta"):
            self.model = HiDreamTransformer(self.hd_config)

    def _build_config(self, layout: Optional[Dict] = None) -> HiDreamConfig:
        """The published layout (or the `_tiny` test sizes), the [model]
        size knobs and llama_layers over it, and `layout` (read from a
        checkpoint) over those."""
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype,
                                      remat=remat_spec(self.config), **block_kernel_kwargs(mc))
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        kwargs.update({k: int(mc[k]) for k in SIZE_KNOBS if mc.get(k) is not None})
        if mc.get("llama_layers"):
            kwargs["llama_layers"] = tuple(int(i) for i in mc["llama_layers"])
        kwargs.update(layout or {})
        if mc.get("_tiny", False):
            return HiDreamConfig.tiny(**kwargs)
        return HiDreamConfig(**kwargs)

    def init_params(self, generator: torch.Generator) -> None:
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    # --- training -----------------------------------------------------------

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 16, H, W], the cached t5_embeds, pooled and
        llama_embeds, optional mask [B, Hm, Wm] (packed as Flux packs it).
        x_t = (1 - t) latents + t noise goes in packed with t x 1,000, and
        the target is latents - noise: the sign flipped against Flux."""
        latents = batch["latents"].to(self.device, torch.float32)
        b, c, h, w = latents.shape
        image_seq_len = (h // 2) * (w // 2)
        mask = batch.get("mask")
        if mask is not None:
            mask = pack_latents(resize_mask_to_latents(mask.to(self.device), h, w, c))
        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator, quantile=timestep_quantile,
                                 image_seq_len=image_seq_len, device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1)
        dt = self.hd_config.dtype
        inputs = dict(x_tokens=pack_latents((1.0 - t_exp) * latents + t_exp * noise).to(dt),
                      img_ids=latent_image_ids(h // 2, w // 2, device=self.device),
                      timesteps=t * 1000.0, img_seq_len=image_seq_len,
                      **{k: batch[k].to(self.device, dt) for k in self.text_keys})
        return inputs, pack_latents(latents - noise), mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, noise: Optional[torch.Tensor] = None, **embeds):
        """Euler flow sampling through the training forward: latents [B, 16,
        height/8, width/8] f32, model.shift as the sigmas' shift. The model
        predicts latents - noise, so the velocity is its output negated."""
        from ..training.sampling import euler_flow_sample

        cfg = self.hd_config
        text = {k: embeds[k].to(self.device, cfg.dtype) for k in self.text_keys}
        b = text["t5_embeds"].shape[0]
        h, w = height // 8, width // 8
        img_ids = latent_image_ids(h // 2, w // 2, device=self.device)

        def vel(x, t):
            out = self.forward(dict(x_tokens=pack_latents(x).to(cfg.dtype), img_ids=img_ids,
                                    timesteps=t * 1000.0, img_seq_len=(h // 2) * (w // 2),
                                    **text))
            return -unpack_latents(out.float(), h, w)

        return euler_flow_sample(vel, (b, cfg.in_channels // 4, h, w), generator,
                                 num_steps=num_steps, guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift"), noise=noise,
                                 device=self.device)

    # --- caching encoders ----------------------------------------------------

    def _load_vae(self):
        from .flux import FluxPipeline

        return FluxPipeline._load_vae(self)

    def get_call_vae_fn(self):
        """fn(pixels) -> {"latents": [B, 16, H/8, W/8]}: the Flux VAE."""
        from .flux import FluxPipeline

        return FluxPipeline.get_call_vae_fn(self)

    def get_call_text_encoder_fns(self):
        """[pooled fn, T5 fn, Llama fn], each captions -> {name: f32 CPU
        tensor}: CLIP-L's and CLIP-bigG's pooled outputs concatenated
        ({pooled} [B, 2,048]), T5-XXL at max_t5_sequence_length ({t5_embeds}
        [B, 128, 4,096]) and Llama-3.1-8B's output of every layer at
        max_llama3_sequence_length ({llama_embeds} [B, 32, 128, 4,096]),
        the Llama weights in fp8 under llama3_4bit. Under `_tiny`, the JAX
        hook's seeded draws (8 T5 rows, 2 Llama layers of 8 rows)."""
        from .llm_encoders import LLMTextEncoder
        from .text_encoders import HFTextEncoder

        mc = self.model_config
        if mc.get("_tiny", False):
            return [self._tiny_text_fn]
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        kw = dict(device=self.device, dtype=te_dtype)
        clip_l = HFTextEncoder("clip_pooled", mc["clip_l_path"], max_length=77, **kw)
        clip_g = HFTextEncoder("clip_pooled", mc["clip_g_path"], max_length=77, **kw)
        t5 = HFTextEncoder("t5", mc["t5_path"],
                           max_length=int(mc.get("max_t5_sequence_length", 128)), **kw)
        llama = LLMTextEncoder(mc["llama3_path"],
                               max_length=int(mc.get("max_llama3_sequence_length", 128)),
                               stack_layers=True, fp8=bool(mc.get("llama3_4bit")), **kw)

        def pooled_fn(captions):
            return {"pooled": torch.cat([clip_l.encode(captions), clip_g.encode(captions)], -1)}

        def t5_fn(captions):
            return {"t5_embeds": t5.encode(captions)}

        def llama_fn(captions):
            return {"llama_embeds": llama.encode(captions, return_mask=False)}

        return [pooled_fn, t5_fn, llama_fn]

    def _tiny_text_fn(self, captions):
        """The JAX `_tiny` hook: per caption, numpy's generator seeded with
        its hash draws T5 rows, the pooled vector and the Llama layers, in
        that order."""
        import numpy as np

        from ..data.bucketing import seed_from_hash

        cfg = self.hd_config
        out = {"t5_embeds": [], "pooled": [], "llama_embeds": []}
        for c in captions:
            r = np.random.default_rng(seed_from_hash(c))
            out["t5_embeds"].append(r.standard_normal((TINY_TEXT_LENGTH, cfg.t5_dim)))
            out["pooled"].append(r.standard_normal((cfg.pooled_dim,)))
            out["llama_embeds"].append(r.standard_normal(
                (TINY_LLAMA_LAYERS, TINY_TEXT_LENGTH, cfg.llama_dim)))
        return {k: torch.from_numpy(np.stack(v).astype(np.float32)) for k, v in out.items()}

    # --- weights -------------------------------------------------------------

    def _keymap_config(self):
        return self.hd_config

    def keymap(self):
        return hidream_keymap(self.hd_config)

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The transformer the model config names (ComfyUI fp8 dequantized,
        model.merge_adapters fused in) as the port's state dict, the model
        rebuilt on the checkpoint's layout first (a [model] size that
        disagrees with it raises); a key missing or left over raises."""
        from .keymaps import (keymap_to_state_dict, layout_override, load_sd_for_pipeline,
                              strip_known_prefixes)

        sd = strip_known_prefixes(load_sd_for_pipeline(self), self.keymap())
        layout = layout_override(self.model_config,
                                 hidream_checkpoint_layout(sd, self.hd_config.head_dim))
        if any(getattr(self.hd_config, k) != v for k, v in layout.items()):
            self.hd_config = self._build_config(layout)
            with torch.device("meta"):
                self.model = HiDreamTransformer(self.hd_config)
        return keymap_to_state_dict(sd, self.keymap(), self.hd_config)
