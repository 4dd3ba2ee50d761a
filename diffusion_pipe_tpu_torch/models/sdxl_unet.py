"""SDXL UNet (diffusers UNet2DConditionModel's architecture) in PyTorch, NCHW.

Counterpart of diffusion_pipe_tpu/models/sdxl_unet.py, with its module
names (`conv_in`, `time_embedding_1`, `down_{i}_res_{j}`,
`down_{i}_attn_{j}.blocks.{k}.attn1_to_q`, `mid_attn`, `up_{i}_upsample`,
...), so interop.tree_to_state_dict maps the JAX parameters onto it (a Conv
`kernel` [kh, kw, in, out] becomes `weight` [out, in, kh, kw], a Dense
`kernel` is transposed, `block_{k}` becomes `blocks.{k}`, a norm `scale`
becomes `weight`). The JAX module works in NHWC; this one in NCHW.

Three down stages (plain, 2-deep and 10-deep cross-attention transformers),
a 10-deep mid block, mirrored up stages with skip concatenations, and
SDXL's time + (pooled text, time ids) additive conditioning. Self- and
cross-attention run through ops/attention.dot_product_attention, so the
flash kernels K1-K3 take them on the card at head dim 64. LoRA / LoKr sit
on every linear of the transformer blocks (q, k, v, out of both
attentions, the GEGLU projection and ff_out), as in the JAX module.

Dtypes follow the Flax module: convolutions and linears store
param_dtype and compute in dtype; group norms (eps 1e-5 in the resnets and
the output, 1e-6 in the transformers' `norm`) keep f32 parameters and give
an f32 result, which the next convolution or linear casts; layer norms
keep f32 parameters and give dtype. The GEGLU gate is tanh-approximated
gelu (flax nn.gelu). With `remat` set, each resnet and transformer
sub-block runs under layers.remat_call with that policy while gradients
are on (the JAX remat_wrap).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import LoraDense, layer_norm, lecun_normal_, remat_call, sinusoidal_timestep_embedding


@dataclasses.dataclass(frozen=True)
class SDXLConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    transformer_layers: Tuple[int, ...] = (0, 2, 10)  # per down stage
    attention_head_dim: int = 64
    cross_attention_dim: int = 2048
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816  # 1280 + 6 * 256
    norm_groups: int = 32
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    lora_rank: int = 0
    lora_alpha: float = 0.0
    lora_dropout: float = 0.0
    lora_dtype: torch.dtype = torch.float32
    lora_type: str = "lora"
    lokr_factor: int = -1
    lokr_rank_dropout: float = 0.0
    remat: str = ""

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def lora_kwargs(self) -> dict:
        return dict(lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                    lora_dropout=self.lora_dropout, lora_dtype=self.lora_dtype,
                    lora_type=self.lora_type, lokr_factor=self.lokr_factor,
                    lokr_rank_dropout=self.lokr_rank_dropout)

    @property
    def dd(self) -> dict:
        return dict(dtype=self.dtype, param_dtype=self.param_dtype)

    @staticmethod
    def tiny(**kw) -> "SDXLConfig":
        d = dict(block_out_channels=(16, 32, 32), transformer_layers=(0, 1, 2),
                 attention_head_dim=8, cross_attention_dim=32,
                 projection_class_embeddings_input_dim=16 + 6 * 256, norm_groups=8,
                 dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return SDXLConfig(**d)


class GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm with its default f32 parameters: normalized in f32,
    the result f32 whatever the input's dtype."""

    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__(groups, channels, eps=eps, dtype=torch.float32)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


class Conv(nn.Conv2d):
    """flax nn.Conv: parameters stored in param_dtype, computed in dtype."""

    def __init__(self, cin: int, cout: int, k: int, cfg: SDXLConfig, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
                        self.padding)


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm(dtype=dtype): f32 parameters and statistics, the
    result in dtype."""

    def __init__(self, dim: int, dtype):
        super().__init__(dim, eps=1e-5, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        return layer_norm(x, self.eps, self.weight, self.bias).to(self.compute_dtype)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: SDXLConfig):
        super().__init__()
        self.norm1 = GroupNorm(cfg.norm_groups, cin, 1e-5)
        self.conv1 = Conv(cin, cout, 3, cfg)
        self.time_emb_proj = LoraDense(cfg.time_embed_dim, cout, **cfg.dd)
        self.norm2 = GroupNorm(cfg.norm_groups, cout, 1e-5)
        self.conv2 = Conv(cout, cout, 3, cfg)
        self.conv_shortcut = Conv(cin, cout, 1, cfg) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, cfg: SDXLConfig):
        super().__init__()
        self.dim = dim
        self.heads = dim // cfg.attention_head_dim
        self.head_dim = cfg.attention_head_dim
        kw = dict(**cfg.dd, **cfg.lora_kwargs)
        ctx = cfg.cross_attention_dim
        for prefix, kv_dim in (("attn1", dim), ("attn2", ctx)):
            self.add_module(f"{prefix}_to_q", LoraDense(dim, dim, use_bias=False, **kw))
            self.add_module(f"{prefix}_to_k", LoraDense(kv_dim, dim, use_bias=False, **kw))
            self.add_module(f"{prefix}_to_v", LoraDense(kv_dim, dim, use_bias=False, **kw))
            self.add_module(f"{prefix}_to_out", LoraDense(dim, dim, **kw))
        self.norm1 = LayerNorm(dim, cfg.dtype)
        self.norm2 = LayerNorm(dim, cfg.dtype)
        self.norm3 = LayerNorm(dim, cfg.dtype)
        self.ff_proj = LoraDense(dim, 8 * dim, **kw)
        self.ff_out = LoraDense(4 * dim, dim, **kw)

    def _attn(self, prefix, y, ctx):
        b, s, _ = y.shape
        lc = ctx.shape[1]
        q = getattr(self, f"{prefix}_to_q")(y).reshape(b, s, self.heads, self.head_dim)
        k = getattr(self, f"{prefix}_to_k")(ctx).reshape(b, lc, self.heads, self.head_dim)
        v = getattr(self, f"{prefix}_to_v")(ctx).reshape(b, lc, self.heads, self.head_dim)
        o = dot_product_attention(q, k, v).reshape(b, s, self.dim)
        return getattr(self, f"{prefix}_to_out")(o)

    def forward(self, x, context):
        y = self.norm1(x)
        x = x + self._attn("attn1", y, y)
        x = x + self._attn("attn2", self.norm2(x), context)
        a, g = self.ff_proj(self.norm3(x)).chunk(2, dim=-1)
        return x + self.ff_out(a * F.gelu(g, approximate="tanh"))


class Transformer2DModel(nn.Module):
    def __init__(self, dim: int, depth: int, cfg: SDXLConfig):
        super().__init__()
        self.norm = GroupNorm(cfg.norm_groups, dim, 1e-6)
        self.proj_in = LoraDense(dim, dim, **cfg.dd)
        self.blocks = nn.ModuleList(BasicTransformerBlock(dim, cfg) for _ in range(depth))
        self.proj_out = LoraDense(dim, dim, **cfg.dd)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.norm(x).reshape(b, c, h * w).transpose(1, 2)
        y = self.proj_in(y)
        for block in self.blocks:
            y = block(y, context)
        y = self.proj_out(y)
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class SDXLUNet(nn.Module):
    def __init__(self, config: SDXLConfig):
        super().__init__()
        cfg = self.config = config
        chs = cfg.block_out_channels
        ted = cfg.time_embed_dim
        self.time_embedding_1 = LoraDense(chs[0], ted, **cfg.dd)
        self.time_embedding_2 = LoraDense(ted, ted, **cfg.dd)
        self.add_embedding_1 = LoraDense(cfg.projection_class_embeddings_input_dim, ted, **cfg.dd)
        self.add_embedding_2 = LoraDense(ted, ted, **cfg.dd)
        self.conv_in = Conv(cfg.in_channels, chs[0], 3, cfg)
        cin = chs[0]
        skip_chs = [cin]  # the widths the down path keeps for the up path
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock2D(cin, ch, cfg))
                cin = ch
                if cfg.transformer_layers[i] > 0:
                    self.add_module(f"down_{i}_attn_{j}",
                                    Transformer2DModel(ch, cfg.transformer_layers[i], cfg))
                skip_chs.append(ch)
            if i < len(chs) - 1:
                self.add_module(f"down_{i}_downsample", Conv(ch, ch, 3, cfg, stride=2))
                skip_chs.append(ch)
        self.mid_res_0 = ResnetBlock2D(cin, cin, cfg)
        self.mid_attn = Transformer2DModel(cin, cfg.transformer_layers[-1], cfg)
        self.mid_res_1 = ResnetBlock2D(cin, cin, cfg)
        rev_depths = list(reversed(cfg.transformer_layers))
        for i, ch in enumerate(reversed(chs)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock2D(cin + skip_chs.pop(), ch, cfg))
                cin = ch
                if rev_depths[i] > 0:
                    self.add_module(f"up_{i}_attn_{j}", Transformer2DModel(ch, rev_depths[i], cfg))
            if i < len(chs) - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, 3, cfg))
        self.conv_norm_out = GroupNorm(cfg.norm_groups, cin, 1e-5)
        self.conv_out = Conv(cin, cfg.out_channels, 3, cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The convolutions and norms as Flax initialises them:
        lecun-normal kernels over in * kh * kw, zero biases, norm scales one
        (the LoraDense linears initialise themselves)."""
        for m in self.modules():
            if isinstance(m, Conv):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                m.bias.zero_()
            elif isinstance(m, (GroupNorm, LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def _run(self, name, *args):
        """A resnet or transformer sub-block, checkpointed under `remat`
        while gradients are on."""
        block = getattr(self, name)
        if self.config.remat and torch.is_grad_enabled():
            return remat_call(self.config.remat, block, *args)
        return block(*args)

    def forward(self, sample, timesteps, encoder_hidden_states, add_text_embeds, add_time_ids):
        """sample [B, 4, H, W] noisy latents, timesteps [B] (integers),
        encoder_hidden_states [B, 77 * chunks, 2048] (CLIP-L and bigG
        penultimate states concatenated), add_text_embeds [B, 1280] (bigG's
        pooled), add_time_ids [B, 6] -> [B, 4, H, W] in dtype."""
        cfg = self.config
        dt = cfg.dtype
        t_proj = sinusoidal_timestep_embedding(timesteps.float(), cfg.block_out_channels[0],
                                               flip_sin_to_cos=True, downscale_freq_shift=0.0)
        temb = self.time_embedding_2(F.silu(self.time_embedding_1(t_proj.to(dt))))
        ids_proj = sinusoidal_timestep_embedding(
            add_time_ids.reshape(-1).float(), cfg.addition_time_embed_dim,
            flip_sin_to_cos=True, downscale_freq_shift=0.0).reshape(add_time_ids.shape[0], -1)
        add_embeds = torch.cat([add_text_embeds.float(), ids_proj], dim=-1)
        temb = temb + self.add_embedding_2(F.silu(self.add_embedding_1(add_embeds.to(dt))))
        ctx = encoder_hidden_states.to(dt)

        n = len(cfg.block_out_channels)
        h = self.conv_in(sample.to(dt))
        skips = [h]
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = self._run(f"down_{i}_res_{j}", h, temb)
                if cfg.transformer_layers[i] > 0:
                    h = self._run(f"down_{i}_attn_{j}", h, ctx)
                skips.append(h)
            if i < n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)
        h = self._run("mid_res_0", h, temb)
        h = self._run("mid_attn", h, ctx)
        h = self._run("mid_res_1", h, temb)
        rev_depths = list(reversed(cfg.transformer_layers))
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = self._run(f"up_{i}_res_{j}", torch.cat([h, skips.pop()], dim=1), temb)
                if rev_depths[i] > 0:
                    h = self._run(f"up_{i}_attn_{j}", h, ctx)
            if i < n - 1:
                h = getattr(self, f"up_{i}_upsample")(F.interpolate(h, scale_factor=2,
                                                                    mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))
