"""LTX-2 (its 13 B video path): the transformer and its pipeline.

Counterpart of diffusion_pipe_tpu/models/ltx2.py, as the JAX package has it
(its readings of the published model are unverified: the connector's block
body, the caption projection, the RoPE and the text projection; ROADMAP C).
Training feeds the audio-video transformer no audio, so the video path is
the model: 48 blocks at 4,096 wide (32 heads of 128) over the LTX VAE's
128-channel latent tokens, each block LTX-Video's with
- bias-free linears and RMS pre-norms without scale (eps 1e-6), the
  cross-attention's input normalised too;
- a prompt-modulated cross-attention: the caption rows RMS-normalised and
  modulated by the block's prompt_scale_shift_table [2, D] plus the
  prompt adaLN-single's 2 x dim output, then attended without a mask;
- RoPE (32, 48, 48) at theta 10,000 on each head, from latent coordinates
  (time / 24, h, w).
Gemma 3's states (the video half of a dual text stream, if the cached rows
are that wide) go through caption_projection and the 1-D embeddings
connector: the caption padded to max(1,024, L) rows by the tiled
learnable registers, which also take every masked row, then 2 blocks of
1-D RoPE self-attention (heads of 64) and a GELU MLP, bias-free, and a
final RMS norm; the blocks attend to all of its rows. The connector and
the embedders carry no adapter in either package, so under LoRA their
attention takes no gradient and runs K1 alone.

The pipeline: rectified flow (t x 1,000 inside the adaLN-single), the
target noise - latents; the VAE is LTX-Video's (models/ltx_vae.py); the
text Gemma-3's last hidden state through the port's LLMTextEncoder, 512
rows. Keys are the JAX keymap's (`transformer_blocks.{i}`,
`video_embeddings_connector.transformer_1d_blocks.{i}.attn.q_proj`, ...),
the LoRA under `diffusion_model.`; the checkpoint's audio branch passes
through to a full export. blocks_to_swap is not ported.
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
from .flux import resize_mask_to_latents
from .hunyuan_video import build_mm_config, load_mm_checkpoint
from .hunyuan_video_model import block_dense, plain_dense
from .layers import RMSNorm, apply_rope, init_module_weights, remat_call, rope_frequencies
from .ltx_video import (SIZE_KNOBS, AdaLNSingle, LTXVAEMixin, _head_mods, _heads,
                        ltx_block_keymap, rms_no_affine, table_mods, tokens_to_video,
                        video_tokens)


@dataclasses.dataclass(frozen=True)
class LTX2Config:
    in_channels: int = 128
    out_channels: int = 128
    hidden_size: int = 4096
    num_heads: int = 32
    num_layers: int = 48
    mlp_ratio: float = 4.0
    cross_attention_dim: int = 4096       # the caption rows' width
    audio_cross_attention_dim: int = 1024
    connector_registers: int = 128
    connector_min_len: int = 1024
    connector_blocks: int = 2
    rope_axes_dim: Tuple[int, ...] = (32, 48, 48)
    rope_theta: float = 10000.0
    timestep_scale_multiplier: float = 1000.0
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

    @staticmethod
    def tiny(**kw) -> "LTX2Config":
        """The JAX LTX2Config.tiny sizes."""
        d = dict(in_channels=16, out_channels=16, hidden_size=32, num_heads=4, num_layers=2,
                 cross_attention_dim=24, audio_cross_attention_dim=8, connector_registers=4,
                 connector_min_len=16, connector_blocks=1, rope_axes_dim=(4, 2, 2),
                 dtype=torch.float32, param_dtype=torch.float32)
        d.update(kw)
        return LTX2Config(**d)


class ConnectorBlock(nn.Module):
    def __init__(self, cfg: LTX2Config, d: int):
        super().__init__()
        for n in ("attn_q", "attn_k", "attn_v", "attn_o"):
            setattr(self, n, plain_dense(cfg, d, d, use_bias=False))
        self.mlp_in = plain_dense(cfg, d, 4 * d, use_bias=False)
        self.mlp_out = plain_dense(cfg, 4 * d, d, use_bias=False)

    def forward(self, x, heads, cos, sin):
        y = rms_no_affine(x)
        q = apply_rope(_heads(self.attn_q(y), heads), cos, sin)
        k = apply_rope(_heads(self.attn_k(y), heads), cos, sin)
        v = _heads(self.attn_v(y), heads)
        x = x + self.attn_o(dot_product_attention(q, k, v).flatten(2))
        return x + self.mlp_out(F.gelu(self.mlp_in(rms_no_affine(x)), approximate="tanh"))


class Connector1D(nn.Module):
    """The embeddings connector (see module docstring): [B, L, d] rows and
    their mask -> [B, max(connector_min_len, L), d], every row valid."""

    def __init__(self, cfg: LTX2Config, d: int):
        super().__init__()
        self.cfg = cfg
        self.learnable_registers = nn.Parameter(torch.empty(cfg.connector_registers, d,
                                                            dtype=cfg.param_dtype))
        self.blocks = nn.ModuleList([ConnectorBlock(cfg, d) for _ in range(cfg.connector_blocks)])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        tmp = torch.randn(self.learnable_registers.shape, generator=generator,
                          dtype=torch.float32, device=self.learnable_registers.device)
        self.learnable_registers.copy_(tmp.mul_(0.02))

    def forward(self, x, mask):
        cfg = self.cfg
        b, length, d = x.shape
        target = max(cfg.connector_min_len, length)
        reps = -(-target // cfg.connector_registers)
        tiled = self.learnable_registers.to(cfg.dtype).repeat(reps, 1)[:target]
        mask = mask.to(torch.bool)
        if target > length:
            x = torch.cat([x, tiled[None, length:].expand(b, -1, -1)], dim=1)
            mask = torch.cat([mask, mask.new_zeros((b, target - length))], dim=1)
        x = torch.where(mask[..., None], x, tiled[None])
        hd = d // max(1, d // 64)
        pos = torch.arange(target, dtype=torch.float32, device=x.device)[:, None]
        cos, sin = rope_frequencies(pos, (hd,), cfg.rope_theta)
        for block in self.blocks:
            x = block(x, d // hd, cos, sin)
        return rms_no_affine(x)


class LTX2Block(nn.Module):
    """The video path of LTX-2's audio-video block (see module docstring)."""

    def __init__(self, cfg: LTX2Config):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=cfg.param_dtype))
        self.prompt_scale_shift_table = nn.Parameter(torch.empty(2, dim, dtype=cfg.param_dtype))
        for a in ("attn1", "attn2"):
            for p in ("q", "k", "v", "out"):
                setattr(self, f"{a}_to_{p}", block_dense(cfg, dim, dim, use_bias=False))
            setattr(self, f"{a}_norm_q", RMSNorm(dim, param_dtype=cfg.param_dtype))
            setattr(self, f"{a}_norm_k", RMSNorm(dim, param_dtype=cfg.param_dtype))
        self.ff_in = block_dense(cfg, dim, int(dim * cfg.mlp_ratio), use_bias=False)
        self.ff_out = block_dense(cfg, int(dim * cfg.mlp_ratio), dim, use_bias=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for table in (self.scale_shift_table, self.prompt_scale_shift_table):
            tmp = torch.randn(table.shape, generator=generator, dtype=torch.float32,
                              device=table.device)
            table.copy_(tmp.mul_(self.cfg.hidden_size ** -0.5))

    def forward(self, x, timestep_6d, prompt_2d, context, rope_cos, rope_sin):
        """x [B, S, D]; timestep_6d [B, 6 D]; prompt_2d [B, 2 D]; context the
        connector's rows [B, L, D]."""
        cfg = self.cfg
        heads = cfg.num_heads
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = table_mods(
            self.scale_shift_table, timestep_6d, x.shape[0], 6)
        y = (rms_no_affine(x).float() * (1.0 + sc_msa) + sh_msa).to(cfg.dtype)
        q = apply_rope(_heads(self.attn1_norm_q(self.attn1_to_q(y)), heads), rope_cos, rope_sin)
        k = apply_rope(_heads(self.attn1_norm_k(self.attn1_to_k(y)), heads), rope_cos, rope_sin)
        v = _heads(self.attn1_to_v(y), heads)
        y = self.attn1_to_out(dot_product_attention(q, k, v).flatten(2))
        x = x + (g_msa * y.float()).to(x.dtype)

        p_shift, p_scale = table_mods(self.prompt_scale_shift_table, prompt_2d, x.shape[0], 2)
        ctx = (rms_no_affine(context).float() * (1.0 + p_scale) + p_shift).to(cfg.dtype)
        y = rms_no_affine(x)
        qc = _heads(self.attn2_norm_q(self.attn2_to_q(y)), heads)
        kc = _heads(self.attn2_norm_k(self.attn2_to_k(ctx)), heads)
        vc = _heads(self.attn2_to_v(ctx), heads)
        x = x + self.attn2_to_out(dot_product_attention(qc, kc, vc).flatten(2))

        y = (rms_no_affine(x).float() * (1.0 + sc_mlp) + sh_mlp).to(cfg.dtype)
        y = self.ff_out(F.gelu(self.ff_in(y), approximate="tanh"))
        return x + (g_mlp * y.float()).to(x.dtype)


class LTX2Transformer(nn.Module):
    def __init__(self, cfg: LTX2Config):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.patchify_proj = plain_dense(cfg, cfg.in_channels, dim)
        self.adaln_single = AdaLNSingle(cfg, 6)
        self.prompt_adaln_proj = plain_dense(cfg, dim, 2 * dim)
        self.caption_projection = plain_dense(cfg, cfg.cross_attention_dim, dim)
        self.video_embeddings_connector = Connector1D(cfg, dim)
        self.blocks = nn.ModuleList([LTX2Block(cfg) for _ in range(cfg.num_layers)])
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
        cross_attention_dim] (or cross + audio wide: the video half is
        taken) with prompt_mask [B, L]; t [B] in [0, 1]; fractional_coords
        [B, 3, S] (time / 24, h, w latent indices) -> [B, S, C] in the model
        dtype."""
        cfg = self.cfg
        h = self.patchify_proj(x.to(cfg.dtype))
        timestep_6d, embedded = self.adaln_single(t)
        prompt_2d = self.prompt_adaln_proj(F.silu(embedded))
        if prompt_embeds.shape[-1] == cfg.cross_attention_dim + cfg.audio_cross_attention_dim:
            prompt_embeds = prompt_embeds[..., :cfg.cross_attention_dim]
        ctx = self.video_embeddings_connector(
            self.caption_projection(prompt_embeds.to(cfg.dtype)), prompt_mask)
        cos, sin = rope_frequencies(fractional_coords[0].transpose(0, 1), cfg.rope_axes_dim,
                                    cfg.rope_theta)
        for block in self.blocks:
            h = self._run(block, h, timestep_6d, prompt_2d, ctx, cos, sin)
        shift, scale = _head_mods(self.scale_shift_table, embedded, h.shape[0])
        y = rms_no_affine(h).float() * (1.0 + scale) + shift
        return self.proj_out(y.to(cfg.dtype))


def ltx2_keymap(cfg: LTX2Config):
    """LTX-2 keys (the JAX keymap's: adaln_single, prompt_adaln_single,
    caption_projection.linear, the connector's transformer_1d_blocks) <->
    the port's names; LoRA under `diffusion_model.`; the audio branch
    passes through."""
    from .keymaps import BlockGroup, KeyMap

    linears, norms, raw = ltx_block_keymap(("scale_shift_table", "prompt_scale_shift_table"))
    top_linears = {"patchify_proj": "patchify_proj",
                   "adaln_single.linear_1": "adaln_single.emb.timestep_embedder.linear_1",
                   "adaln_single.linear_2": "adaln_single.emb.timestep_embedder.linear_2",
                   "adaln_single.proj": "adaln_single.linear",
                   "prompt_adaln_proj": "prompt_adaln_single.linear",
                   "caption_projection": "caption_projection.linear", "proj_out": "proj_out"}
    for i in range(cfg.connector_blocks):
        ours = f"video_embeddings_connector.blocks.{i}"
        base = f"video_embeddings_connector.transformer_1d_blocks.{i}"
        top_linears.update({f"{ours}.attn_{p}": f"{base}.attn.{p}_proj" for p in "qkvo"})
        top_linears.update({f"{ours}.mlp_in": f"{base}.mlp.fc1",
                            f"{ours}.mlp_out": f"{base}.mlp.fc2"})
    return KeyMap(
        blocks=[BlockGroup("blocks", "transformer_blocks", "num_layers", linears=linears,
                           norms=norms, raw=raw)],
        top_linears=top_linears,
        top_raw={"scale_shift_table": "scale_shift_table",
                 "video_embeddings_connector.learnable_registers":
                     "video_embeddings_connector.learnable_registers"},
        lora_prefix="diffusion_model.", passthrough_patterns=(r"audio", r"^av_ca_"))


def ltx2_checkpoint_layout(sd) -> Dict[str, Any]:
    """What a (prefix-stripped) LTX-2 checkpoint holds: the width and latent
    channels, the block count, the MLP ratio, the output channels, the
    caption width (caption_projection's input), the connector's block and
    register counts (the heads do not show: model.num_heads, 32)."""
    from .hunyuan_video import _shape
    from .keymaps import count_blocks

    dim, in_ch = _shape(sd, "patchify_proj.weight")
    return dict(hidden_size=dim, in_channels=in_ch,
                num_layers=count_blocks(sd, "transformer_blocks"),
                mlp_ratio=_shape(sd, "transformer_blocks.0.ff.net.0.proj.weight")[0] / dim,
                out_channels=_shape(sd, "proj_out.weight")[0],
                cross_attention_dim=_shape(sd, "caption_projection.linear.weight")[1],
                connector_blocks=count_blocks(
                    sd, "video_embeddings_connector.transformer_1d_blocks"),
                connector_registers=_shape(
                    sd, "video_embeddings_connector.learnable_registers")[0])


@register_model("ltx2")
class LTX2Pipeline(LTXVAEMixin, BasePipeline):
    name = "ltx2"
    framerate = 24
    text_keys = ("text_embeds_0", "attention_mask_0")

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, device)
        if int(config.get("blocks_to_swap", 0) or 0) > 0:
            raise NotImplementedError("blocks_to_swap is not ported yet")
        self.tdist = TimestepDistribution.from_model_config(self.model_config)
        self.ltx2_config = self._build_config()
        with torch.device("meta"):
            self.model = LTX2Transformer(self.ltx2_config)

    def _build_config(self, layout: Optional[Dict] = None) -> LTX2Config:
        return build_mm_config(self, LTX2Config, layout, knobs=SIZE_KNOBS + ("cross_attention_dim",))

    def _latent_channels(self) -> int:
        return self.ltx2_config.in_channels

    def init_params(self, generator: torch.Generator) -> None:
        self.model.to_empty(device=self.device)
        init_module_weights(self.model, generator)

    # --- training -----------------------------------------------------------

    def latent_coords(self, f: int, h: int, w: int, b: int) -> torch.Tensor:
        """[B, 3, F H W]: each token's (frame / 24, h, w) latent indices."""
        axes = [torch.arange(n, dtype=torch.float32, device=self.device) for n in (f, h, w)]
        axes[0] = axes[0] / self.framerate
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"))
        return grid.reshape(1, 3, -1).expand(b, -1, -1)

    def _text(self, batch, b: int):
        return dict(prompt_embeds=batch["text_embeds_0"].to(self.device, self.ltx2_config.dtype),
                    prompt_mask=batch["attention_mask_0"].to(self.device).reshape(b, -1))

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 128, F, H, W] (or [B, 128, H, W]), the cached
        Gemma rows and mask, optional mask [B, Hm, Wm] (as tokens [B, S,
        1]). noise and t are drawn from `generator` unless given."""
        latents = batch["latents"].to(self.device, torch.float32)
        if latents.dim() == 4:
            latents = latents[:, :, None]
        b, _, f, h, w = latents.shape
        mask = batch.get("mask")
        if mask is not None:
            mask = resize_mask_to_latents(mask.to(self.device), h, w, 1)[:, :, None]
            mask = video_tokens(mask.expand(b, 1, f, h, w))
        if t is None:
            t = sample_timesteps(b, self.tdist, generator=generator, quantile=timestep_quantile,
                                 image_seq_len=(h // 2) * (w // 2), device=self.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=self.device)
        t = t.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        t_exp = t.reshape(b, 1, 1, 1, 1)
        x_t = (1.0 - t_exp) * latents + t_exp * noise
        inputs = dict(x=video_tokens(x_t).to(self.ltx2_config.dtype), t=t,
                      fractional_coords=self.latent_coords(f, h, w, b), **self._text(batch, b))
        return inputs, video_tokens(noise - latents), mask

    def forward(self, model_inputs):
        return self.model(**model_inputs)

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, num_frames: int = 1,
               noise: Optional[torch.Tensor] = None, **embeds):
        """Euler flow sampling through the training forward: latents [B, 128,
        1 + (num_frames - 1) // 8, height / 32, width / 32] f32."""
        from ..training.sampling import euler_flow_sample

        b = embeds["text_embeds_0"].shape[0]
        cfg = self.ltx2_config
        fhw = (max(1, (int(num_frames) - 1) // 8 + 1), height // 32, width // 32)
        text, coords = self._text(embeds, b), self.latent_coords(*fhw, b)

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
        """[Gemma fn]: captions -> {text_embeds_0 [B, 512, width] f32 (Gemma
        3's last hidden state, model.text_encoder_path), attention_mask_0
        int32}. Under `_tiny`, the JAX hook's draws (8 rows, the first
        len(caption) + 1 valid)."""
        from .llm_encoders import LLMTextEncoder
        from .text_encoders import seeded_caption_draws

        mc = self.model_config
        if mc.get("_tiny", False):
            def tiny(captions):
                e, m = seeded_caption_draws(captions, 8, self.ltx2_config.cross_attention_dim)
                return {"text_embeds_0": e, "attention_mask_0": m}

            return [tiny]
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        enc = LLMTextEncoder(mc["text_encoder_path"],
                             max_length=int(mc.get("max_sequence_length", 512)), hidden_layer=-1,
                             device=self.device, dtype=te_dtype)

        def fn(captions):
            h, m = enc.encode(captions)
            return {"text_embeds_0": h, "attention_mask_0": m.to(torch.int32)}

        return [fn]

    # --- weights -------------------------------------------------------------

    def _keymap_config(self):
        return self.ltx2_config

    def keymap(self):
        return ltx2_keymap(self.ltx2_config)

    def load_weights(self) -> Dict[str, torch.Tensor]:
        """The transformer [model] names as the port's state dict (the
        single file's `vae.*` left to the VAE, its audio branch passed
        through), the model rebuilt on the checkpoint's layout first; a key
        missing or left over raises."""
        return load_mm_checkpoint(self, "ltx2_config", ltx2_checkpoint_layout,
                                  drop_prefixes=("vae.",))
