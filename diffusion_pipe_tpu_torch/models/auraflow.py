"""AuraFlow (v0.3): the transformer and its pipeline.

Counterpart of diffusion_pipe_tpu/models/auraflow.py (diffusers'
AuraFlowTransformer2DModel): patchified latents plus a learned position
table centre-cropped to the image's patch grid, 8 learned register tokens
before the projected Pile-T5 context, 4 joint (MMDiT) blocks over separate
image and context streams with joint [ctx, img] attention, then 32 single
blocks over the concatenated stream. Every block has the "sandwich"
residual (the attention output enters only through norm2(x + gate * attn)
and the modulated SwiGLU; the block adds gate_mlp * ff to its input),
fp32 non-affine layer norms, a non-affine per-head layer norm on q and k
and bias-free linears. Attention runs on K1-K3 at head dim 256 (12 heads
of 256 at width 3,072), unmasked. The timestep goes in as t in [0, 1]
times 1,000 (diffusers' Timesteps(256, flip_sin_to_cos, scale=1000) on
the pipeline's t / 1000): the same function as the JAX module's.

Where the port departs from the JAX module, on purpose:
- the patch projection reads each 2 x 2 patch in diffusers'
  AuraFlowPatchEmbed order, (channel, row, column), the order in which a
  checkpoint's pos_embed.proj columns lie; the JAX module flattens it as
  (row, column, channel) and so mixes a real checkpoint's columns.
  interop.jax_to_state_dict reorders the JAX kernel's rows
  (patch_proj_from_jax) when it carries a JAX model;
- a KeyMap in diffusers' names (the names convert_diffusers_auraflow
  reads), so the driver saves and re-imports an adapter and a fully
  fine-tuned model; the JAX pipeline has none and cannot save either.

Every block linear (16 a joint block, 8 a single block, the modulation
linears among them) takes the adapter, base_kernel_dtype (fp8 storage) and
int8_matmul; the embedders, the table, the registers and the head keep
param_dtype. With `remat` set each block runs under remat_call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import dtype_from_string
from ..ops.attention import dot_product_attention
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .layers import (LoraDense, adapter_kwargs, block_kernel_kwargs, init_module_weights,
                     layer_norm, modulate, remat_call, remat_spec,
                     sinusoidal_timestep_embedding)

TINY_TEXT_LENGTH = 8


@dataclasses.dataclass(frozen=True)
class AuraFlowConfig:
    in_channels: int = 4
    out_channels: int = 4
    patch_size: int = 2
    hidden_size: int = 3072
    num_attention_heads: int = 12
    attention_head_dim: int = 256
    joint_attention_dim: int = 2048  # Pile-T5-XL's width
    num_layers: int = 4              # joint (MMDiT) blocks
    num_single_layers: int = 32
    num_register_tokens: int = 8
    pos_embed_max_size: int = 9216   # a 96 x 96 grid (v0.3)
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
    def ffn_dim(self) -> int:
        """SwiGLU's inner width: 2/3 of 4 x hidden, up to a multiple of 256."""
        d = int(2 * (4 * self.hidden_size) / 3)
        return ((d + 255) // 256) * 256

    def dense(self, in_features: int, features: int) -> LoraDense:
        """A block linear: the adapter, fp8 storage and int8 compute."""
        return LoraDense(in_features, features, use_bias=False, dtype=self.dtype,
                         param_dtype=self.param_dtype, lora_rank=self.lora_rank,
                         lora_alpha=self.lora_alpha, lora_dropout=self.lora_dropout,
                         lora_dtype=self.lora_dtype, kernel_dtype=self.base_kernel_dtype,
                         int8_matmul=self.int8_matmul, lora_type=self.lora_type,
                         lokr_factor=self.lokr_factor, lokr_rank_dropout=self.lokr_rank_dropout)

    @staticmethod
    def tiny(**kw) -> "AuraFlowConfig":
        """The JAX AuraFlowConfig.tiny sizes."""
        d = dict(hidden_size=32, num_attention_heads=4, attention_head_dim=8,
                 joint_attention_dim=24, num_layers=2, num_single_layers=2,
                 pos_embed_max_size=64, dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return AuraFlowConfig(**d)


def _qk_norm(x: torch.Tensor) -> torch.Tensor:
    """The non-affine fp32 layer norm over the head dim (diffusers'
    fp32_layer_norm without elementwise affine)."""
    return layer_norm(x, eps=1e-5)


def _add_swiglu(block: nn.Module, prefix: str, cfg: AuraFlowConfig) -> None:
    dim, ffn = cfg.hidden_size, cfg.ffn_dim
    setattr(block, f"{prefix}_linear_1", cfg.dense(dim, ffn))
    setattr(block, f"{prefix}_linear_2", cfg.dense(dim, ffn))
    setattr(block, f"{prefix}_out_projection", cfg.dense(ffn, dim))


def _swiglu(block: nn.Module, prefix: str, x: torch.Tensor) -> torch.Tensor:
    gate = getattr(block, f"{prefix}_linear_1")(x)
    up = getattr(block, f"{prefix}_linear_2")(x)
    return getattr(block, f"{prefix}_out_projection")(F.silu(gate) * up)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, heads, -1)


class AuraFlowJointBlock(nn.Module):
    def __init__(self, cfg: AuraFlowConfig):
        super().__init__()
        self.cfg = cfg
        dim, inner = cfg.hidden_size, cfg.num_attention_heads * cfg.attention_head_dim
        self.norm1_linear = cfg.dense(dim, 6 * dim)
        self.norm1_context_linear = cfg.dense(dim, 6 * dim)
        for prefix in ("attn_to", "attn_add"):
            for p in ("q", "k", "v"):
                setattr(self, f"{prefix}_{p}", cfg.dense(dim, inner))
        self.attn_to_out = cfg.dense(inner, dim)
        self.attn_to_add_out = cfg.dense(inner, dim)
        _add_swiglu(self, "ff", cfg)
        _add_swiglu(self, "ff_context", cfg)

    def _qkv(self, x, prefix):
        heads = self.cfg.num_attention_heads
        q, k, v = (_heads(getattr(self, f"{prefix}_{p}")(x), heads) for p in ("q", "k", "v"))
        return _qk_norm(q), _qk_norm(k), v

    def forward(self, img, ctx, temb):
        act = F.silu(temb)
        i_sh, i_sc, i_g, i_sh2, i_sc2, i_g2 = self.norm1_linear(act).chunk(6, dim=-1)
        c_sh, c_sc, c_g, c_sh2, c_sc2, c_g2 = self.norm1_context_linear(act).chunk(6, dim=-1)
        iq, ik, iv = self._qkv(modulate(layer_norm(img), i_sh, i_sc), "attn_to")
        cq, ck, cv = self._qkv(modulate(layer_norm(ctx), c_sh, c_sc), "attn_add")
        attn = dot_product_attention(torch.cat([cq, iq], dim=1), torch.cat([ck, ik], dim=1),
                                     torch.cat([cv, iv], dim=1)).flatten(2)
        cl = ctx.shape[1]
        img_attn = self.attn_to_out(attn[:, cl:])
        ctx_attn = self.attn_to_add_out(attn[:, :cl])
        h = modulate(layer_norm(img + i_g[:, None] * img_attn), i_sh2, i_sc2)
        img = img + i_g2[:, None] * _swiglu(self, "ff", h)
        h = modulate(layer_norm(ctx + c_g[:, None] * ctx_attn), c_sh2, c_sc2)
        ctx = ctx + c_g2[:, None] * _swiglu(self, "ff_context", h)
        return img, ctx


class AuraFlowSingleBlock(nn.Module):
    def __init__(self, cfg: AuraFlowConfig):
        super().__init__()
        self.cfg = cfg
        dim, inner = cfg.hidden_size, cfg.num_attention_heads * cfg.attention_head_dim
        self.norm1_linear = cfg.dense(dim, 6 * dim)
        self.attn_to_q = cfg.dense(dim, inner)
        self.attn_to_k = cfg.dense(dim, inner)
        self.attn_to_v = cfg.dense(dim, inner)
        self.attn_to_out = cfg.dense(inner, dim)
        _add_swiglu(self, "ff", cfg)

    def forward(self, x, temb):
        heads = self.cfg.num_attention_heads
        sh, sc, g, sh2, sc2, g2 = self.norm1_linear(F.silu(temb)).chunk(6, dim=-1)
        h = modulate(layer_norm(x), sh, sc)
        q = _qk_norm(_heads(self.attn_to_q(h), heads))
        k = _qk_norm(_heads(self.attn_to_k(h), heads))
        v = _heads(self.attn_to_v(h), heads)
        attn = self.attn_to_out(dot_product_attention(q, k, v).flatten(2))
        h = modulate(layer_norm(x + g[:, None] * attn), sh2, sc2)
        return x + g2[:, None] * _swiglu(self, "ff", h)


def pe_selection_indices(pos_max: int, hp: int, wp: int) -> np.ndarray:
    """The centre crop of the learned position table's sqrt(pos_max)-sided
    grid to (hp, wp) patches, as flat indices (diffusers'
    AuraFlowPatchEmbed.pe_selection_index_based_on_dim)."""
    side = int(pos_max ** 0.5)
    idx = np.arange(pos_max).reshape(side, side)
    sh, sw = side // 2 - hp // 2, side // 2 - wp // 2
    return idx[sh:sh + hp, sw:sw + wp].reshape(-1)


class AuraFlowTransformer(nn.Module):
    def __init__(self, cfg: AuraFlowConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        dd = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        p = cfg.patch_size
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.pos_embed_max_size, dim,
                                                  dtype=cfg.param_dtype))
        self.register_tokens = nn.Parameter(torch.empty(1, cfg.num_register_tokens, dim,
                                                        dtype=cfg.param_dtype))
        self.patch_proj = LoraDense(p * p * cfg.in_channels, dim, **dd)
        self.context_embedder = LoraDense(cfg.joint_attention_dim, dim, use_bias=False, **dd)
        self.time_linear_1 = LoraDense(256, dim, **dd)
        self.time_linear_2 = LoraDense(dim, dim, **dd)
        self.joint_blocks = nn.ModuleList([AuraFlowJointBlock(cfg)
                                           for _ in range(cfg.num_layers)])
        self.single_blocks = nn.ModuleList([AuraFlowSingleBlock(cfg)
                                            for _ in range(cfg.num_single_layers)])
        self.norm_out_linear = LoraDense(dim, 2 * dim, use_bias=False, **dd)
        self.proj_out_linear = LoraDense(dim, p * p * cfg.out_channels, use_bias=False, **dd)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The table and the registers: normal draws of std 0.02 (the JAX
        module's initializers), drawn in f32."""
        for t in (self.pos_embed, self.register_tokens):
            tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
            t.copy_(tmp.normal_(0.0, 0.02, generator=generator))

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(self, latents, encoder_hidden_states, timestep):
        """latents [B, C, H, W]; encoder_hidden_states [B, S, joint dim];
        timestep [B] in [0, 1] -> [B, C, H, W]."""
        cfg = self.cfg
        b, c, hh, ww = latents.shape
        p = cfg.patch_size
        hp, wp = hh // p, ww // p
        # diffusers' patch order: (channel, row, column) within a patch
        x = latents.reshape(b, c, hp, p, wp, p).permute(0, 2, 4, 1, 3, 5)
        x = self.patch_proj(x.reshape(b, hp * wp, c * p * p).to(cfg.dtype))
        sel = torch.from_numpy(pe_selection_indices(cfg.pos_embed_max_size, hp, wp))
        x = x + self.pos_embed[:, sel.to(x.device)].to(cfg.dtype)
        temb = sinusoidal_timestep_embedding(timestep.float(), 256, scale=1000.0)
        temb = self.time_linear_2(F.silu(self.time_linear_1(temb.to(cfg.dtype))))
        ctx = self.context_embedder(encoder_hidden_states.to(cfg.dtype))
        reg = self.register_tokens.to(cfg.dtype).expand(b, -1, -1)
        ctx = torch.cat([reg, ctx], dim=1)
        for block in self.joint_blocks:
            x, ctx = self._run(block, x, ctx, temb)
        combined = torch.cat([ctx, x], dim=1)
        for block in self.single_blocks:
            combined = self._run(block, combined, temb)
        out = combined[:, ctx.shape[1]:]
        scale, shift = self.norm_out_linear(F.silu(temb)).chunk(2, dim=-1)  # diffusers order
        out = self.proj_out_linear(modulate(layer_norm(out), shift, scale))
        out = out.reshape(b, hp, wp, p, p, cfg.out_channels).permute(0, 5, 1, 3, 2, 4)
        return out.reshape(b, cfg.out_channels, hh, ww)


def patch_proj_from_jax(weight: torch.Tensor, in_channels: int, patch: int) -> torch.Tensor:
    """The JAX module's patch projection [out, (row, col, channel)] as the
    port's [out, (channel, row, col)] (see the module docstring)."""
    out = weight.shape[0]
    w = weight.reshape(out, patch, patch, in_channels).permute(0, 3, 1, 2)
    return w.reshape(out, -1).contiguous()


# diffusers' names of the block linears (those convert_diffusers_auraflow reads)
JOINT_LINEARS = {
    "norm1_linear": "norm1.linear", "norm1_context_linear": "norm1_context.linear",
    "attn_to_q": "attn.to_q", "attn_to_k": "attn.to_k", "attn_to_v": "attn.to_v",
    "attn_add_q": "attn.add_q_proj", "attn_add_k": "attn.add_k_proj",
    "attn_add_v": "attn.add_v_proj", "attn_to_out": "attn.to_out.0",
    "attn_to_add_out": "attn.to_add_out",
    "ff_linear_1": "ff.linear_1", "ff_linear_2": "ff.linear_2",
    "ff_out_projection": "ff.out_projection",
    "ff_context_linear_1": "ff_context.linear_1", "ff_context_linear_2": "ff_context.linear_2",
    "ff_context_out_projection": "ff_context.out_projection",
}
SINGLE_LINEARS = {k: v for k, v in JOINT_LINEARS.items() if "context" not in k and "add" not in k}
TOP_LINEARS = {"patch_proj": "pos_embed.proj", "context_embedder": "context_embedder",
               "time_linear_1": "time_step_proj.linear_1",
               "time_linear_2": "time_step_proj.linear_2",
               "norm_out_linear": "norm_out.linear", "proj_out_linear": "proj_out"}


def auraflow_keymap():
    """diffusers AuraFlowTransformer2DModel keys <-> the port's names; the
    `model.` prefix of the original checkpoints is stripped; LoRA in the
    ComfyUI dialect (`diffusion_model.` prefix)."""
    from .keymaps import BlockGroup, KeyMap

    return KeyMap(
        blocks=[BlockGroup("joint_blocks", "joint_transformer_blocks", "num_layers",
                           linears=JOINT_LINEARS),
                BlockGroup("single_blocks", "single_transformer_blocks", "num_single_layers",
                           linears=SINGLE_LINEARS)],
        top_linears=TOP_LINEARS,
        top_raw={"pos_embed": "pos_embed.pos_embed", "register_tokens": "register_tokens"},
        lora_prefix="diffusion_model.",
        strip_prefixes=("model.diffusion_model.", "diffusion_model.", "transformer.", "model."),
    )


def convert_diffusers_auraflow(sd, cfg: AuraFlowConfig) -> Dict[str, torch.Tensor]:
    """A diffusers AuraFlowTransformer2DModel state dict -> the port's state
    dict (the JAX convert_diffusers_auraflow's map, in torch's layouts)."""
    from .keymaps import keymap_to_state_dict

    return keymap_to_state_dict(sd, auraflow_keymap(), cfg)


def auraflow_checkpoint_layout(sd) -> Dict[str, Any]:
    """What a (prefix-stripped) diffusers checkpoint holds: the block
    counts, the table's size, the registers, the text width and the latent
    channels."""
    from .keymaps import count_blocks

    p2 = AuraFlowConfig.patch_size ** 2
    return dict(num_layers=count_blocks(sd, "joint_transformer_blocks"),
                num_single_layers=count_blocks(sd, "single_transformer_blocks"),
                pos_embed_max_size=int(sd["pos_embed.pos_embed"].shape[1]),
                num_register_tokens=int(sd["register_tokens"].shape[1]),
                joint_attention_dim=int(sd["context_embedder.weight"].shape[1]),
                in_channels=int(sd["pos_embed.proj.weight"].shape[1]) // p2,
                out_channels=int(sd["proj_out.weight"].shape[0]) // p2)


@register_model("auraflow")
class AuraFlowPipeline(BasePipeline):
    name = "auraflow"

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.af_config = self._build_config()
        with torch.device("meta"):
            self.model = AuraFlowTransformer(self.af_config)

    def _build_config(self, layout: Optional[Dict] = None) -> AuraFlowConfig:
        """v0.3's layout, the `_tiny` test layout, or `layout` (read from a
        checkpoint); [model]'s pos_embed_max_size overrides the table."""
        mc = self.model_config
        dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
        kwargs: Dict[str, Any] = dict(dtype=dtype, param_dtype=dtype,
                                      remat=remat_spec(self.config), **block_kernel_kwargs(mc))
        kwargs.update(adapter_kwargs(self.config, mc.get("dtype", "bfloat16")))
        for knob in ("pos_embed_max_size", "num_layers", "num_single_layers"):
            if mc.get(knob):
                kwargs[knob] = int(mc[knob])
        kwargs.update(layout or {})
        if mc.get("_tiny", False):
            return AuraFlowConfig.tiny(**kwargs)
        return AuraFlowConfig(**kwargs)

    def init_params(self, generator: torch.Generator) -> None:
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 4, H, W], prompt_embeds [B, S, 2048], optional
        mask [B, Hm, Wm] (nearest-resized to [B, 1, H, W]). The target is
        noise - latents, unpacked."""
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
        x_t = (1.0 - t_exp) * latents + t_exp * noise
        inputs = dict(latents=x_t,
                      encoder_hidden_states=batch["prompt_embeds"].to(self.device),
                      timestep=t)
        return inputs, noise - latents, mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, prompt_embeds, width: int, height: int, generator=None,
               num_steps: int = 20, guidance_scale: float = 1.0,
               noise: Optional[torch.Tensor] = None, **_unused):
        """Euler flow sampling through the training forward: latents [B, 4,
        height/8, width/8] f32, model.shift as the sigmas' shift."""
        from ..training.sampling import euler_flow_sample

        cfg = self.af_config
        b = prompt_embeds.shape[0]

        def vel(x, t):
            return self.forward(dict(latents=x.to(cfg.dtype), encoder_hidden_states=prompt_embeds,
                                     timestep=t)).float()

        return euler_flow_sample(vel, (b, cfg.in_channels, height // 8, width // 8), generator,
                                 num_steps=num_steps, guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift"), noise=noise,
                                 device=self.device)

    # --- caching encoders ----------------------------------------------------

    def _load_vae(self):
        from .sdxl import SDXLPipeline

        return SDXLPipeline._load_vae(self)

    def get_call_vae_fn(self):
        """fn(pixels) -> {"latents": [B, 4, H/8, W/8]}: AuraFlow ships the
        SDXL VAE, loaded as the port's SDXL pipeline loads it."""
        from .sdxl import SDXLPipeline

        return SDXLPipeline.get_call_vae_fn(self)

    def get_call_text_encoder_fns(self):
        """[fn]: captions -> {"prompt_embeds": [B, 256, 2048] f32}: Pile-T5
        (the HF T5 encoder) from model.text_encoder_path with
        max_sequence_length tokens (256); under `_tiny`, the JAX hook's
        seeded draws (8 rows)."""
        from .text_encoders import HFTextEncoder, seeded_draws

        mc = self.model_config
        if mc.get("_tiny", False):
            dim = self.af_config.joint_attention_dim
            return [lambda caps: {"prompt_embeds": seeded_draws(caps, "",
                                                                (TINY_TEXT_LENGTH, dim))}]
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        enc = HFTextEncoder("t5", mc["text_encoder_path"],
                            max_length=int(mc.get("max_sequence_length", 256)),
                            tokenizer_path=mc.get("tokenizer_path"), device=self.device,
                            dtype=te_dtype)

        def fn(captions):
            return {"prompt_embeds": enc.encode(captions)}

        return [fn]

    # --- weights -------------------------------------------------------------

    def _keymap_config(self):
        return self.af_config

    def keymap(self):
        return auraflow_keymap()

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The transformer of model.transformer_path (diffusers or the
        original `model.`-prefixed keys; ComfyUI fp8 dequantized,
        model.merge_adapters fused in after the prefix strip) as the port's
        state dict, the model rebuilt on the checkpoint's layout first."""
        from .keymaps import layout_override, strip_known_prefixes
        from .weights import (dequantize_comfy_fp8, load_safetensors_dir,
                              merge_adapters_into_state_dict)

        mc = self.model_config
        sd = strip_known_prefixes(load_safetensors_dir(mc["transformer_path"]), self.keymap())
        sd = merge_adapters_into_state_dict(dequantize_comfy_fp8(sd), mc.get("merge_adapters"))
        layout = layout_override(mc, auraflow_checkpoint_layout(sd))
        if any(getattr(self.af_config, k) != v for k, v in layout.items()):
            self.af_config = self._build_config(layout)
            with torch.device("meta"):
                self.model = AuraFlowTransformer(self.af_config)
        return convert_diffusers_auraflow(sd, self.af_config)
