"""Cosmos-Predict2 MiniTrainDIT, the transformer of Cosmos-Predict2, Anima
and Cosmos-1 (models/cosmos_predict2.py, models/cosmos.py).

Counterpart of diffusion_pipe_tpu/models/cosmos_predict2_model.py. A
block has three sub-blocks, each behind its own adaLN(-LoRA) modulation
(shift, scale, gate) and a non-affine LayerNorm in f32 at eps 1e-6:
self-attention over the video tokens (per-head RMS q / k norms, 3-D
NTK-scaled RoPE in the half-rotation convention), cross-attention to the
old-T5 context (RMS q / k norms, no RoPE) and a GELU MLP. The patch
embedding takes a concatenated padding-mask channel; the raw t in [0, 1]
feeds a sinusoidal (cos | sin) embedding, and with adaLN-LoRA the
RMS-normed sinusoid itself (not the timestep MLP's output) is the blocks'
modulation input, the MLP's output their shared `adaln_lora` term.
Attention runs on K1-K3 (ops/attention.py) at head dim 128.

The block linears take the adapter, fp8 storage and int8 compute. The
six modulation linears of each block take the adapter too (the JAX
module gives them none; the reference's PEFT adapts every linear of its
target blocks) but keep the model dtype otherwise. The embedders, the
final layer's modulation and the final linear (computed in f32) keep
param_dtype. Module names are the JAX module's (`blocks.{i}.self_attn_q`,
`blocks.{i}.adaln_modulation_mlp_1`, `final_adaln_2`); the keymap
(models/cosmos_predict2.py) gives the reference checkpoint's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import LoraDense, RMSNorm, layer_norm, remat_call


@dataclasses.dataclass(frozen=True)
class CosmosPredict2Config:
    in_channels: int = 16
    out_channels: int = 16
    patch_spatial: int = 2
    patch_temporal: int = 1
    model_channels: int = 2048
    num_blocks: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    crossattn_emb_channels: int = 1024
    concat_padding_mask: bool = True
    use_adaln_lora: bool = True
    adaln_lora_dim: int = 256
    rope_h_extrapolation_ratio: float = 1.0
    rope_w_extrapolation_ratio: float = 1.0
    rope_t_extrapolation_ratio: float = 1.0
    rope_enable_fps_modulation: bool = False
    base_fps: int = 24
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
        return self.model_channels // self.num_heads

    def _adapter(self) -> dict:
        return dict(lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                    lora_dropout=self.lora_dropout, lora_dtype=self.lora_dtype,
                    lora_type=self.lora_type, lokr_factor=self.lokr_factor,
                    lokr_rank_dropout=self.lokr_rank_dropout)

    def dense(self, in_features: int, features: int) -> LoraDense:
        """A block linear: the adapter, fp8 storage and int8 compute."""
        return LoraDense(in_features, features, use_bias=False, dtype=self.dtype,
                         param_dtype=self.param_dtype, kernel_dtype=self.base_kernel_dtype,
                         int8_matmul=self.int8_matmul, **self._adapter())

    def modulation_dense(self, in_features: int, features: int) -> LoraDense:
        """A block's modulation linear: the adapter, the model dtype."""
        return LoraDense(in_features, features, use_bias=False, dtype=self.dtype,
                         param_dtype=self.param_dtype, **self._adapter())

    def plain(self, in_features: int, features: int, use_bias: bool = False,
              dtype: Optional[torch.dtype] = None) -> LoraDense:
        return LoraDense(in_features, features, use_bias=use_bias, dtype=dtype or self.dtype,
                         param_dtype=self.param_dtype)

    @staticmethod
    def p2b_2b(**kw) -> "CosmosPredict2Config":
        """Cosmos-Predict2-2B: 28 blocks, 2,048 wide, 16 heads of 128."""
        d = dict(model_channels=2048, num_blocks=28, num_heads=16)
        d.update(kw)
        return CosmosPredict2Config(**d)

    @staticmethod
    def tiny(**kw) -> "CosmosPredict2Config":
        """The JAX CosmosPredict2Config.tiny sizes (4 heads of 16)."""
        d = dict(model_channels=64, num_blocks=2, num_heads=4, crossattn_emb_channels=32,
                 adaln_lora_dim=16, dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return CosmosPredict2Config(**d)


def cosmos_rope_angles(cfg: CosmosPredict2Config, t: int, h: int, w: int,
                       fps: Optional[float] = None, device=None) -> torch.Tensor:
    """[t h w, head_dim] f32 rotation angles, computed in float64 as the
    JAX function computes them with numpy: per-axis dims dim_h = dim_w =
    dim // 6 * 2 and dim_t the rest, NTK-scaled thetas, fps modulation of
    the time axis (when enabled, with fps given and t > 1), the layout
    cat([t, h, w] halves) twice."""
    f64 = torch.float64
    dim = cfg.head_dim
    dim_h = dim // 6 * 2
    dim_t = dim - 2 * dim_h
    h_theta = 10000.0 * cfg.rope_h_extrapolation_ratio ** (dim_h / (dim_h - 2))
    w_theta = 10000.0 * cfg.rope_w_extrapolation_ratio ** (dim_h / (dim_h - 2))
    t_theta = 10000.0 * cfg.rope_t_extrapolation_ratio ** (dim_t / (dim_t - 2))
    sp_range = torch.arange(0, dim_h, 2, dtype=f64)[: dim_h // 2] / dim_h
    t_range = torch.arange(0, dim_t, 2, dtype=f64)[: dim_t // 2] / dim_t
    seq_t = torch.arange(t, dtype=f64)
    if cfg.rope_enable_fps_modulation and fps is not None and t > 1:
        seq_t = seq_t / fps * cfg.base_fps
    emb_t = torch.outer(seq_t, 1.0 / t_theta ** t_range)
    emb_h = torch.outer(torch.arange(h, dtype=f64), 1.0 / h_theta ** sp_range)
    emb_w = torch.outer(torch.arange(w, dtype=f64), 1.0 / w_theta ** sp_range)
    half = torch.cat([emb_t[:, None, None, :].expand(t, h, w, -1),
                      emb_h[None, :, None, :].expand(t, h, w, -1),
                      emb_w[None, None, :, :].expand(t, h, w, -1)], dim=-1)
    half = half.reshape(t * h * w, dim // 2)
    return torch.cat([half, half], dim=-1).to(device=device, dtype=torch.float32)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-rotation RoPE x cos + (-x2, x1) sin in f32, cast back; x [B, S,
    H, D], cos / sin [S, D]."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return (xf * cos[None, :, None, :] + rotated * sin[None, :, None, :]).to(x.dtype)


class CosmosBlock(nn.Module):
    SUBLAYERS = ("self_attn", "cross_attn", "mlp")

    def __init__(self, cfg: CosmosPredict2Config):
        super().__init__()
        self.cfg = cfg
        dim, hd, ctx = cfg.model_channels, cfg.head_dim, cfg.crossattn_emb_channels
        for sub in self.SUBLAYERS:
            name = f"adaln_modulation_{sub}"
            if cfg.use_adaln_lora:
                setattr(self, f"{name}_1", cfg.modulation_dense(dim, cfg.adaln_lora_dim))
                setattr(self, f"{name}_2", cfg.modulation_dense(cfg.adaln_lora_dim, 3 * dim))
            else:
                setattr(self, f"{name}_1", cfg.modulation_dense(dim, 3 * dim))
        for p in ("self_attn", "cross_attn"):
            kv_in = dim if p == "self_attn" else ctx
            setattr(self, f"{p}_q", cfg.dense(dim, dim))
            setattr(self, f"{p}_k", cfg.dense(kv_in, dim))
            setattr(self, f"{p}_v", cfg.dense(kv_in, dim))
            setattr(self, f"{p}_o", cfg.dense(dim, dim))
            setattr(self, f"{p}_q_norm", RMSNorm(hd, 1e-6, cfg.param_dtype))
            setattr(self, f"{p}_k_norm", RMSNorm(hd, 1e-6, cfg.param_dtype))
        hidden = int(dim * cfg.mlp_ratio)
        self.mlp_1 = cfg.dense(dim, hidden)
        self.mlp_2 = cfg.dense(hidden, dim)

    def _modulation(self, sub, emb_silu, adaln_lora):
        name = f"adaln_modulation_{sub}"
        y = getattr(self, f"{name}_1")(emb_silu)
        if self.cfg.use_adaln_lora:
            y = getattr(self, f"{name}_2")(y) + adaln_lora
        shift, scale, gate = y.chunk(3, dim=-1)
        return shift[:, None], scale[:, None], gate[:, None]

    def _attn(self, p, y, kv, cos=None, sin=None):
        b, s, _ = y.shape
        heads, hd = self.cfg.num_heads, self.cfg.head_dim
        q = getattr(self, f"{p}_q_norm")(getattr(self, f"{p}_q")(y).reshape(b, s, heads, hd))
        k = getattr(self, f"{p}_k_norm")(
            getattr(self, f"{p}_k")(kv).reshape(b, kv.shape[1], heads, hd))
        v = getattr(self, f"{p}_v")(kv).reshape(b, kv.shape[1], heads, hd)
        if cos is not None:
            q, k = apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)
        return getattr(self, f"{p}_o")(dot_product_attention(q, k, v).reshape(b, s, -1))

    def forward(self, x, emb, adaln_lora, context, cos, sin):
        """x [B, S, dim]; emb [B, dim] (the blocks' modulation input);
        adaln_lora [B, 3 dim]; context [B, Lc, ctx]; cos / sin [S, head_dim]."""
        e = F.silu(emb)
        shift, scale, gate = self._modulation("self_attn", e, adaln_lora)
        y = layer_norm(x) * (1 + scale) + shift
        x = x + gate * self._attn("self_attn", y, y, cos, sin)
        shift, scale, gate = self._modulation("cross_attn", e, adaln_lora)
        y = layer_norm(x) * (1 + scale) + shift
        x = x + gate * self._attn("cross_attn", y, context)
        shift, scale, gate = self._modulation("mlp", e, adaln_lora)
        y = layer_norm(x) * (1 + scale) + shift
        return x + gate * self.mlp_2(F.gelu(self.mlp_1(y)))


class CosmosPredict2Transformer(nn.Module):
    """The MiniTrainDIT; `llm_adapter` (Anima's trainable LLMAdapter, run by
    the pipeline before this module) is a submodule when given, so the
    trainer sees its parameters beside the DiT's."""

    def __init__(self, cfg: CosmosPredict2Config, llm_adapter: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        dim, ps, pt = cfg.model_channels, cfg.patch_spatial, cfg.patch_temporal
        in_ch = cfg.in_channels + int(cfg.concat_padding_mask)
        self.x_embedder = cfg.plain(in_ch * pt * ps * ps, dim)
        self.t_embedder_1 = cfg.plain(dim, dim, use_bias=not cfg.use_adaln_lora)
        self.t_embedder_2 = cfg.plain(dim, 3 * dim if cfg.use_adaln_lora else dim)
        self.t_embedding_norm = RMSNorm(dim, 1e-6, cfg.param_dtype)
        self.blocks = nn.ModuleList([CosmosBlock(cfg) for _ in range(cfg.num_blocks)])
        if cfg.use_adaln_lora:
            self.final_adaln_1 = cfg.plain(dim, cfg.adaln_lora_dim)
            self.final_adaln_2 = cfg.plain(cfg.adaln_lora_dim, 2 * dim)
        else:
            self.final_adaln_1 = cfg.plain(dim, 2 * dim)
        self.final_linear = cfg.plain(dim, ps * ps * pt * cfg.out_channels, dtype=torch.float32)
        if llm_adapter is not None:
            self.llm_adapter = llm_adapter

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(self, x, t, context, fps: Optional[float] = None, padding_mask=None):
        """x [B, C, T, H, W]; t [B] (raw, in [0, 1] for flow matching, EDM's
        c_noise for Cosmos-1); context [B, Lc, ctx] -> [B, C_out, T, H, W]."""
        cfg = self.cfg
        dim, dt = cfg.model_channels, cfg.dtype
        ps, pt = cfg.patch_spatial, cfg.patch_temporal
        b, c, tt, hh, ww = x.shape
        gt, gh, gw = tt // pt, hh // ps, ww // ps
        if cfg.concat_padding_mask:
            pm = (padding_mask if padding_mask is not None
                  else torch.zeros((b, 1, tt, hh, ww), dtype=x.dtype, device=x.device))
            x = torch.cat([x, pm.to(x.dtype)], dim=1)
            c += 1
        # a patch flattens as (channel, time, row, column)
        xe = x.reshape(b, c, gt, pt, gh, ps, gw, ps).permute(0, 2, 4, 6, 1, 3, 5, 7)
        xe = self.x_embedder(xe.reshape(b, gt * gh * gw, c * pt * ps * ps).to(dt))

        half = dim // 2
        exponent = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                             device=x.device) / half)
        args = t.float()[:, None] * exponent[None]
        sincos = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        e2 = self.t_embedder_2(F.silu(self.t_embedder_1(sincos.to(dt))))
        if cfg.use_adaln_lora:
            emb, adaln_lora = sincos.to(dt), e2
        else:
            emb, adaln_lora = e2, torch.zeros((b, 3 * dim), dtype=dt, device=x.device)
        emb = self.t_embedding_norm(emb)

        angles = cosmos_rope_angles(cfg, gt, gh, gw, fps, device=x.device)
        cos, sin = torch.cos(angles), torch.sin(angles)
        context = context.to(dt)
        for block in self.blocks:
            xe = self._run(block, xe, emb, adaln_lora, context, cos, sin)

        y = self.final_adaln_1(F.silu(emb))
        if cfg.use_adaln_lora:
            y = self.final_adaln_2(y) + adaln_lora[:, :2 * dim]
        shift, scale = y.float().chunk(2, dim=-1)
        xf = layer_norm(xe.float()) * (1 + scale[:, None]) + shift[:, None]
        out = self.final_linear(xf)
        # the output packs a patch as (row, column, time, channel), unlike
        # the input
        out = out.reshape(b, gt, gh, gw, ps, ps, pt, cfg.out_channels)
        out = out.permute(0, 7, 1, 6, 2, 4, 3, 5)
        return out.reshape(b, cfg.out_channels, gt * pt, gh * ps, gw * ps)
