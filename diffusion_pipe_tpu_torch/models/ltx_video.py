"""LTX-Video (2 B): the transformer and its pipeline.

Counterpart of diffusion_pipe_tpu/models/ltx_video.py. 28 blocks at 2,048
wide (32 heads of 64) over the VAE's 128-channel latent tokens in (f, h, w)
order; PixArt's adaLN-single (a 6 x dim modulation from the timestep, plus
each block's scale_shift_table, gates and tables in f32); RoPE over the
full inner dim before the head split, from pixel coordinates (the time
axis divided by the frame rate) normalised by (20, 2,048, 2,048), its
frequency ladder (pi / 2) theta^linspace(0, 1, dim / 6) built in float64
and cast once; q / k RMS norms over the inner dim; T5-XXL's 4,096-wide rows
through the caption projection (GELU, tanh form). Self-attention runs on
K1-K3 at D 64, the cross-attention to the caption too, with the T5 mask as
the key mask.

The blocks are the published ones (standardization_norm "rms_norm",
adaptive_norm "single_scale_shift"), where the JAX module departs in two
ways (ROADMAP C):
- D1: the pre-norms of the self-attention and the feed-forward are RMS
  norms without affine (eps 1e-6); the JAX module's are LayerNorms;
- D2: the cross-attention reads the raw residual stream; the JAX module
  normalises it first.
The output norm is a LayerNorm in both. interop.ltx_video_config gives the
JAX form (jax_form), for the parity tests; no [model] key reaches it.

The cross-attention's key mask replaces the JAX module's -10000 bias: both
agree on every row with a valid key (exp(-10000) is 0 in f32); a row with
none gives 0 here and the mean of the values there (ROADMAP C). A T5 mask
keeps its EOS.

The pipeline: rectified flow (x_t = (1 - t) latents + t noise, the target
noise - latents), the loss mask divided by its mean, and first-frame
conditioning (model.first_frame_conditioning_p): a conditioned example's
first latent frame is the clean latents, out of the loss, and its tokens
get t = 0 (D3: the published per-token timestep, [B, S]; the JAX pipeline
swaps the frame and masks its loss but keeps one t per example). With p =
0, the default, both agree. Keys are Lightricks' (`transformer_blocks.{i}.
attn1.to_q`, `q_norm`, `adaln_single.*`, `caption_projection.linear_1`),
the LoRA under `diffusion_model.`; the single file's `vae.*` keys feed the
VAE (models/ltx_vae.py), not the transformer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import dtype_from_string
from ..ops.attention import dot_product_attention
from ..training.flow import TimestepDistribution, sample_timesteps
from . import register_model
from .base import BasePipeline
from .hunyuan_video import _shape, build_mm_config, load_mm_checkpoint
from .hunyuan_video_model import block_dense, plain_dense
from .layers import (RMSNorm, init_module_weights, layer_norm, remat_call,
                     sinusoidal_timestep_embedding)

# [model] knobs that set the transformer's size
SIZE_KNOBS = ("num_layers", "num_heads")


@dataclasses.dataclass(frozen=True)
class LTXConfig:
    in_channels: int = 128        # the LTX VAE's latent channels
    out_channels: int = 128
    hidden_size: int = 2048
    num_heads: int = 32
    num_layers: int = 28
    caption_dim: int = 4096       # T5-XXL
    mlp_ratio: float = 4.0
    rope_theta: float = 10000.0
    timestep_scale_multiplier: float = 1000.0
    rope_max_pos: Tuple[int, int, int] = (20, 2048, 2048)
    # the first latent frame holds one pixel frame, the others 8: time
    # coordinates clamp(8 t + 1 - 8, 0) (off, as in the published config)
    causal_temporal_positioning: bool = False
    vae_spatial_factor: int = 32
    vae_temporal_factor: int = 8
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
    # the JAX module's blocks: LayerNorm pre-norms (D1), a normalised
    # cross-attention input (D2)
    jax_form: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**kw) -> "LTXConfig":
        """The JAX LTXConfig.tiny sizes."""
        d = dict(in_channels=16, out_channels=16, hidden_size=48, num_heads=4, num_layers=2,
                 caption_dim=32, dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return LTXConfig(**d)


def ltx_rope_tables(coords: torch.Tensor, dim: int, theta: float, max_pos):
    """LTX-Video's RoPE tables (cos, sin) [S, dim / 2] from pixel-space
    coordinates [S, 3] (time / frame rate, h, w): the fractions coords /
    max_pos mapped to [-1, 1], times the ladder (pi / 2) theta^linspace(0,
    1, dim // 6) shared by the three axes, interleaved axis-fastest; the
    leading (dim % 6) / 2 pairs turn by nothing. The ladder is built in
    float64 and cast once: its top phases reach theta pi / 2, where a f32
    linspace moves cos by about 1e-3."""
    s, n = coords.shape[0], dim // 6
    frac = coords.float() / torch.tensor(max_pos, dtype=torch.float32, device=coords.device)
    ladder = torch.tensor(np.power(theta, np.linspace(0.0, 1.0, n, dtype=np.float64))
                          * (np.pi / 2.0), dtype=torch.float32, device=coords.device)
    freqs = (ladder[None, :, None] * (frac[:, None, :] * 2.0 - 1.0)).reshape(s, 3 * n)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    pad = (dim - 6 * n) // 2
    if pad:
        cos = torch.cat([cos.new_ones(s, pad), cos], dim=-1)
        sin = torch.cat([sin.new_zeros(s, pad), sin], dim=-1)
    return cos, sin


def apply_rope_full_dim(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair RoPE of x [B, S, H, Dh] by tables over the full inner
    dim, cos / sin [S, H Dh / 2] (head h reads its own columns: the
    published module turns [B, S, H Dh] before the head split), in f32,
    cast back."""
    b, s, h, hd = x.shape
    c = cos.reshape(s, h, hd // 2)[None]
    sn = sin.reshape(s, h, hd // 2)[None]
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([x0 * c - x1 * sn, x0 * sn + x1 * c], dim=-1).reshape(x.shape).to(x.dtype)


def rms_no_affine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim without a scale, in f32, cast back."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


def table_mods(table: torch.Tensor, emb: torch.Tensor, b: int, n: int):
    """A block's (or the head's) n modulations: table [n, D] plus emb [B, n
    D] or [B, S, n D] (a per-token timestep), in f32: n tensors [B, 1 or
    S, D]."""
    mods = table.float()[None, None] + emb.float().reshape(b, -1, n, table.shape[-1])
    return mods.unbind(2)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    return x.reshape(*x.shape[:2], heads, -1)


class LTXBlock(nn.Module):
    """Lightricks' BasicTransformerBlock (adaLN-single): gated self-attention
    with RoPE, ungated cross-attention to the caption, gated feed-forward."""

    def __init__(self, cfg: LTXConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=cfg.param_dtype))
        for a in ("attn1", "attn2"):
            for p in ("q", "k", "v", "out"):
                setattr(self, f"{a}_to_{p}", block_dense(cfg, dim, dim))
            setattr(self, f"{a}_norm_q", RMSNorm(dim, param_dtype=cfg.param_dtype))
            setattr(self, f"{a}_norm_k", RMSNorm(dim, param_dtype=cfg.param_dtype))
        self.ff_in = block_dense(cfg, dim, int(dim * cfg.mlp_ratio))
        self.ff_out = block_dense(cfg, int(dim * cfg.mlp_ratio), dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        tmp = torch.randn(self.scale_shift_table.shape, generator=generator,
                          dtype=torch.float32, device=self.scale_shift_table.device)
        self.scale_shift_table.copy_(tmp.mul_(self.cfg.hidden_size ** -0.5))

    def _norm(self, x):
        return layer_norm(x) if self.cfg.jax_form else rms_no_affine(x)

    def forward(self, x, timestep_6d, context, context_mask, rope_cos, rope_sin):
        """x [B, S, D]; timestep_6d [B, 6 D] or [B, S, 6 D]; context [B, L,
        D] with context_mask [B, L] (or None)."""
        cfg = self.cfg
        heads = cfg.num_heads
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = table_mods(
            self.scale_shift_table, timestep_6d, x.shape[0], 6)
        y = (self._norm(x).float() * (1.0 + sc_msa) + sh_msa).to(cfg.dtype)
        q = apply_rope_full_dim(_heads(self.attn1_norm_q(self.attn1_to_q(y)), heads),
                                rope_cos, rope_sin)
        k = apply_rope_full_dim(_heads(self.attn1_norm_k(self.attn1_to_k(y)), heads),
                                rope_cos, rope_sin)
        v = _heads(self.attn1_to_v(y), heads)
        y = self.attn1_to_out(dot_product_attention(q, k, v).flatten(2))
        x = x + (g_msa * y.float()).to(x.dtype)

        y = layer_norm(x) if cfg.jax_form else x
        qc = _heads(self.attn2_norm_q(self.attn2_to_q(y)), heads)
        kc = _heads(self.attn2_norm_k(self.attn2_to_k(context)), heads)
        vc = _heads(self.attn2_to_v(context), heads)
        x = x + self.attn2_to_out(dot_product_attention(qc, kc, vc, context_mask).flatten(2))

        y = (self._norm(x).float() * (1.0 + sc_mlp) + sh_mlp).to(cfg.dtype)
        y = self.ff_out(F.gelu(self.ff_in(y), approximate="tanh"))
        return x + (g_mlp * y.float()).to(x.dtype)


class AdaLNSingle(nn.Module):
    """PixArt's adaLN-single: t x 1,000 -> sinusoidal(256) -> linear_1 ->
    SiLU -> linear_2 (the embedded timestep) -> SiLU -> n x dim (JAX names:
    adaln_linear_1 / _2, adaln_proj), for t [B] or a per-token [B, S]."""

    def __init__(self, cfg, n: int):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.linear_1 = plain_dense(cfg, 256, dim)
        self.linear_2 = plain_dense(cfg, dim, dim)
        self.proj = plain_dense(cfg, dim, n * dim)

    def forward(self, t: torch.Tensor):
        """-> (the n x dim modulation, the embedded timestep), each with t's
        leading dims."""
        ts = t.float() * self.cfg.timestep_scale_multiplier
        emb = sinusoidal_timestep_embedding(ts.reshape(-1), 256).reshape(*t.shape, 256)
        embedded = self.linear_2(F.silu(self.linear_1(emb.to(self.cfg.dtype))))
        return self.proj(F.silu(embedded)), embedded


def _head_mods(table, embedded, b):
    """(shift, scale) [B, 1 or S, D] of the head: table [2, D] plus the
    embedded timestep [B, D] or [B, S, D] on each row, in f32."""
    e = embedded.float().reshape(b, -1, 1, table.shape[-1])
    mods = table.float()[None, None] + e
    return mods[:, :, 0], mods[:, :, 1]


class LTXTransformer(nn.Module):
    def __init__(self, cfg: LTXConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.patchify_proj = plain_dense(cfg, cfg.in_channels, dim)
        self.adaln_single = AdaLNSingle(cfg, 6)
        self.caption_projection_1 = plain_dense(cfg, cfg.caption_dim, dim)
        self.caption_projection_2 = plain_dense(cfg, dim, dim)
        self.blocks = nn.ModuleList([LTXBlock(cfg) for _ in range(cfg.num_layers)])
        self.scale_shift_table = nn.Parameter(torch.empty(2, dim, dtype=cfg.param_dtype))
        self.proj_out = plain_dense(cfg, dim, cfg.out_channels)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        tmp = torch.randn(self.scale_shift_table.shape, generator=generator,
                          dtype=torch.float32, device=self.scale_shift_table.device)
        self.scale_shift_table.copy_(tmp.mul_(self.cfg.hidden_size ** -0.5))

    def _run(self, block, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_call(self.cfg.remat, block, *args)
        return block(*args)

    def forward(self, x, prompt_embeds, prompt_mask, t, fractional_coords):
        """x [B, S, C] latent tokens ((f, h, w) order); prompt_embeds [B, L,
        4,096] with prompt_mask [B, L] (or None); t [B] in [0, 1] or per
        token [B, S]; fractional_coords [B, 3, S] (time / frame rate, h, w
        in pixels) -> [B, S, C] in the model dtype."""
        cfg = self.cfg
        h = self.patchify_proj(x.to(cfg.dtype))
        timestep_6d, embedded = self.adaln_single(t)
        ctx = self.caption_projection_2(F.gelu(self.caption_projection_1(
            prompt_embeds.to(cfg.dtype)), approximate="tanh"))
        cos, sin = ltx_rope_tables(fractional_coords[0].transpose(0, 1), cfg.hidden_size,
                                   cfg.rope_theta, cfg.rope_max_pos)
        for block in self.blocks:
            h = self._run(block, h, timestep_6d, ctx, prompt_mask, cos, sin)
        shift, scale = _head_mods(self.scale_shift_table, embedded, h.shape[0])
        y = layer_norm(h).float() * (1.0 + scale) + shift
        return self.proj_out(y.to(cfg.dtype))


def ltx_block_keymap(raw=("scale_shift_table",)):
    """The Lightricks block names of the port's LTXBlock linears and norms
    (LTX-2 shares them)."""
    linears = {f"{a}_to_{p}": f"{a}.to_{p}" for a in ("attn1", "attn2") for p in ("q", "k", "v")}
    linears.update({"attn1_to_out": "attn1.to_out.0", "attn2_to_out": "attn2.to_out.0",
                    "ff_in": "ff.net.0.proj", "ff_out": "ff.net.2"})
    norms = {f"{a}_norm_{p}": f"{a}.{p}_norm" for a in ("attn1", "attn2") for p in ("q", "k")}
    return linears, norms, {r: r for r in raw}


def ltx_video_keymap(cfg: LTXConfig):
    """Lightricks Transformer3DModel keys <-> the port's names (the JAX
    keymap's); LoRA under `diffusion_model.`."""
    from .keymaps import BlockGroup, KeyMap

    linears, norms, raw = ltx_block_keymap()
    return KeyMap(
        blocks=[BlockGroup("blocks", "transformer_blocks", "num_layers", linears=linears,
                           norms=norms, raw=raw)],
        top_linears={"patchify_proj": "patchify_proj",
                     "adaln_single.linear_1": "adaln_single.emb.timestep_embedder.linear_1",
                     "adaln_single.linear_2": "adaln_single.emb.timestep_embedder.linear_2",
                     "adaln_single.proj": "adaln_single.linear",
                     "caption_projection_1": "caption_projection.linear_1",
                     "caption_projection_2": "caption_projection.linear_2",
                     "proj_out": "proj_out"},
        top_raw={"scale_shift_table": "scale_shift_table"},
        lora_prefix="diffusion_model.")


def ltx_checkpoint_layout(sd) -> Dict[str, Any]:
    """What a (prefix-stripped) LTX-Video checkpoint holds: the width and
    latent channels from patchify_proj, the block count, the MLP ratio, the
    output channels and the caption width (the head count does not show in
    the keys: model.num_heads, 32 by default)."""
    from .keymaps import count_blocks

    dim, in_ch = _shape(sd, "patchify_proj.weight")
    return dict(hidden_size=dim, in_channels=in_ch,
                num_layers=count_blocks(sd, "transformer_blocks"),
                mlp_ratio=_shape(sd, "transformer_blocks.0.ff.net.0.proj.weight")[0] / dim,
                out_channels=_shape(sd, "proj_out.weight")[0],
                caption_dim=_shape(sd, "caption_projection.linear_1.weight")[1])


def video_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, F, H, W] -> tokens [B, F H W, C] in (f, h, w) order."""
    return x.flatten(2).transpose(1, 2)


def tokens_to_video(x: torch.Tensor, fhw) -> torch.Tensor:
    """video_tokens' inverse."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], *fhw)


class LTXVAEMixin:
    """The LTX causal VAE of a pipeline ([model] vae_path, or the single
    file's `vae.*` keys; a seeded tiny one under `_tiny` at the model's
    latent width), and get_call_vae_fn over it."""

    def _latent_channels(self) -> int:
        raise NotImplementedError

    def _load_vae(self):
        if getattr(self, "_vae", None) is None:
            from .ltx_vae import LTXVAEConfig, LTXVideoVAE, load_ltx_vae

            mc = self.model_config
            dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
            if mc.get("_tiny", False):
                vae = LTXVideoVAE(LTXVAEConfig.tiny(latent_channels=self._latent_channels(),
                                                    dtype=dtype)).to(self.device)
                vae.init_weights(torch.Generator(device=self.device).manual_seed(0))
            else:
                path = (mc.get("vae_path") or mc.get("single_file_path")
                        or mc.get("ckpt_path"))
                if not path:
                    raise FileNotFoundError(f"{self.name}: set model.vae_path for latent caching")
                vae = load_ltx_vae(path, dtype=dtype, device=self.device)
            if vae.config.latent_channels != self._latent_channels():
                raise ValueError(f"VAE latent width {vae.config.latent_channels} != model "
                                 f"{self._latent_channels()}")
            self._vae = vae.eval().requires_grad_(False)
        return self._vae

    def get_call_vae_fn(self):
        """fn(pixels [B, 3, F, H, W] or [B, 3, H, W] in [-1, 1], numpy) ->
        {"latents": [B, z, 1 + (F - 1) / 8, H / 32, W / 32]} f32 CPU
        tensors, normalised by the VAE's per-channel statistics."""

        def fn(pixels):
            vae = self._load_vae()
            px = torch.from_numpy(np.asarray(pixels, np.float32))
            if px.dim() == 4:
                px = px[:, :, None]
            with torch.no_grad():
                return {"latents": vae.encode(px.to(self.device)).float().cpu()}

        return fn


@register_model("ltx-video", "ltx_video")
class LTXVideoPipeline(LTXVAEMixin, BasePipeline):
    name = "ltx-video"
    framerate = 25
    text_keys = ("prompt_embeds", "prompt_attention_mask")

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.ltx_config = self._build_config()
        self.first_frame_conditioning_p = float(
            self.model_config.get("first_frame_conditioning_p", 0.0))
        with torch.device("meta"):
            self.model = LTXTransformer(self.ltx_config)

    def _build_config(self, layout: Optional[Dict] = None) -> LTXConfig:
        return build_mm_config(self, LTXConfig, layout, knobs=SIZE_KNOBS,
                               causal_temporal_positioning=bool(self.model_config.get(
                                   "causal_temporal_positioning", False)))

    def _latent_channels(self) -> int:
        return self.ltx_config.in_channels

    def init_params(self, generator: torch.Generator) -> None:
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    # --- training -----------------------------------------------------------

    def pixel_coords(self, f: int, h: int, w: int, b: int) -> torch.Tensor:
        """[B, 3, F H W]: each token's (time / frame rate, h, w) in pixels,
        latent index times the VAE's factors ((f, h, w) order; the first
        latent frame at time 0, or every frame 7 earlier, clamped at 0,
        under causal_temporal_positioning)."""
        cfg = self.ltx_config
        tpix = torch.arange(f, dtype=torch.float32, device=self.device) * cfg.vae_temporal_factor
        if cfg.causal_temporal_positioning:
            tpix = (tpix + 1.0 - cfg.vae_temporal_factor).clamp(min=0.0)
        hi = torch.arange(h, dtype=torch.float32, device=self.device) * cfg.vae_spatial_factor
        wi = torch.arange(w, dtype=torch.float32, device=self.device) * cfg.vae_spatial_factor
        grid = torch.stack(torch.meshgrid(tpix / self.framerate, hi, wi, indexing="ij"))
        return grid.reshape(1, 3, -1).expand(b, -1, -1)

    def _text(self, batch, b: int):
        mask = batch.get("prompt_attention_mask")
        return dict(prompt_embeds=batch["prompt_embeds"].to(self.device, self.ltx_config.dtype),
                    prompt_mask=None if mask is None else mask.to(self.device).reshape(b, -1))

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                       first_frame: Optional[torch.Tensor] = None):
        """batch: latents [B, 128, F, H, W], the cached T5 rows and mask,
        optional mask [B, Hm, Wm]. -> (inputs with tokens [B, S, 128], the
        target tokens, the loss mask [B, S, 128] divided by its mean).
        noise, t and first_frame ([B] bool: the examples whose first frame
        conditions, drawn with model.first_frame_conditioning_p) are drawn
        from `generator` unless given. With p > 0, t goes per token [B, S],
        0 on a conditioned first frame's tokens."""
        latents = batch["latents"].to(self.device, torch.float32)
        if latents.dim() == 4:
            latents = latents[:, :, None]
        b, c, f, h, w = latents.shape
        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator, quantile=timestep_quantile,
                                 image_seq_len=h * w, device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1, 1)
        x_t = (1.0 - t_exp) * latents + t_exp * noise
        target = noise - latents
        loss_mask = torch.ones((b, 1, f, h, w), dtype=torch.float32, device=self.device)
        mask = batch.get("mask")
        if mask is not None:
            m = F.interpolate(mask.to(self.device).float()[:, None], size=(h, w),
                              mode="nearest-exact")
            loss_mask = loss_mask * m[:, :, None]
        model_t = t
        p = self.first_frame_conditioning_p
        if p > 0:
            if first_frame is None:
                first_frame = torch.rand((b,), generator=generator, device=self.device) < p
            cond = first_frame.to(self.device).reshape(b, 1, 1, 1, 1) & (
                torch.arange(f, device=self.device).reshape(1, 1, f, 1, 1) == 0)
            x_t = torch.where(cond, latents, x_t)
            loss_mask = torch.where(cond, torch.zeros_like(loss_mask), loss_mask)
            model_t = torch.where(video_tokens(cond.expand(b, 1, f, h, w))[..., 0],
                                  torch.zeros((), device=self.device), t[:, None])
        loss_mask = loss_mask / loss_mask.mean().clamp(min=1e-8)
        inputs = dict(x=video_tokens(x_t).to(self.ltx_config.dtype), t=model_t,
                      fractional_coords=self.pixel_coords(f, h, w, b), **self._text(batch, b))
        return inputs, video_tokens(target), video_tokens(loss_mask.expand(b, c, f, h, w))

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, num_frames: int = 1,
               noise: Optional[torch.Tensor] = None, **embeds):
        """Euler flow sampling through the training forward: latents [B, 128,
        1 + (num_frames - 1) // 8, height / 32, width / 32] f32."""
        from ..training.sampling import euler_flow_sample

        b = embeds["prompt_embeds"].shape[0]
        cfg = self.ltx_config
        fhw = (max(1, (int(num_frames) - 1) // 8 + 1), height // 32, width // 32)
        text, coords = self._text(embeds, b), self.pixel_coords(*fhw, b)

        def vel(x, t):
            out = self.forward(dict(x=video_tokens(x).to(cfg.dtype), t=t,
                                    fractional_coords=coords, **text))
            return tokens_to_video(out.float(), fhw)

        return euler_flow_sample(vel, (b, cfg.in_channels, *fhw), generator,
                                 num_steps=num_steps, guidance_scale=guidance_scale,
                                 shift=self.model_config.get("shift"), noise=noise,
                                 device=self.device)

    # --- caching encoders ----------------------------------------------------

    def get_call_text_encoder_fns(self):
        """[T5 fn]: captions -> {prompt_embeds [B, 128, 4,096] f32,
        prompt_attention_mask int32} from T5-XXL's encoder (model.t5_path,
        max_sequence_length 128). Under `_tiny`, the JAX hook's draws (8
        rows, the first len(caption) + 1 valid)."""
        from .text_encoders import HFTextEncoder, seeded_caption_draws

        mc = self.model_config
        if mc.get("_tiny", False):
            def tiny(captions):
                e, m = seeded_caption_draws(captions, 8, self.ltx_config.caption_dim)
                return {"prompt_embeds": e, "prompt_attention_mask": m}

            return [tiny]
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        t5 = HFTextEncoder("t5", mc["t5_path"], max_length=int(mc.get("max_sequence_length", 128)),
                           device=self.device, dtype=te_dtype)

        def t5_fn(captions):
            h, m = t5.encode(captions, return_mask=True)
            return {"prompt_embeds": h, "prompt_attention_mask": m.to(torch.int32)}

        return [t5_fn]

    # --- weights -------------------------------------------------------------

    def _keymap_config(self):
        return self.ltx_config

    def keymap(self):
        return ltx_video_keymap(self.ltx_config)

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The transformer [model] names (the single file's
        `model.diffusion_model.*`, or a transformer file) as the port's
        state dict, the model rebuilt on the checkpoint's layout first; a key
        missing or left over raises."""
        return load_mm_checkpoint(self, "ltx_config", ltx_checkpoint_layout,
                                  drop_prefixes=("vae.",))
