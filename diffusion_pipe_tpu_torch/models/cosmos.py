"""Cosmos-1: the MiniTrainDIT trained with the EDM objective, on the Cosmos
continuous video tokenizer's latents.

Counterpart of diffusion_pipe_tpu/models/cosmos.py. The transformer is
Cosmos-Predict2's (models/cosmos_predict2_model.py) at Cosmos-1's size
(4,096 wide, 28 blocks, 32 heads of 128 by default; the [model] knobs
model_channels, num_blocks and num_heads, or the checkpoint's keys).
Training (training/edm.py): log-normal sigma, the net input c_in x_t at
t = c_noise, the prediction c_skip x_t + c_out F in f32 held against the
CLEAN latents, the masked MSE times the per-sigma weights. The sampler
takes Euler steps over the Karras schedule (rho 7, sigma 0.002 to 80).
Latents come from the tokenizer (models/cosmos_tokenizer.py; under
`_tiny` the tiny Wan VAE, as in JAX), the text from old-T5-XXL at 512
tokens with the padded rows zeroed (prompt_embeds).

Checkpoints in Predict2's names load through its keymap; the original
Cosmos-1 GeneralDIT serialization (blocks.blockN.blocks.{0,1,2}.block.*,
adaLN_modulation, affline_norm) is converted first by
convert_general_dit_sd, which raises on a key it cannot map (the JAX
function warns and drops it) and skips only the `_extra_state` blobs and
the RoPE `seq` buffer.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import torch

from ..common import dtype_from_string
from ..training.edm import edm_noise, edm_scalings, per_sigma_loss_weights
from . import register_model
from .cosmos_predict2 import CosmosPredict2Pipeline, skip_buffers

# a GeneralDIT attention sub-block's part -> Predict2's
_GD_ATTN = {"to_q.0": "q_proj", "to_q.1": "q_norm", "to_k.0": "k_proj", "to_k.1": "k_norm",
            "to_v.0": "v_proj", "to_out.0": "output_proj"}
# a GeneralDIT block's sub-blocks in Text2World's FA-CA-MLP order
_GD_SUBBLOCK = {"0": ("self_attn", "adaln_modulation_self_attn"),
                "1": ("cross_attn", "adaln_modulation_cross_attn"),
                "2": ("mlp", "adaln_modulation_mlp")}


def _general_dit_name(key: str) -> Optional[str]:
    """The Predict2 name of one prefix-stripped GeneralDIT key, or None."""
    m = re.match(r"blocks\.block(\d+)\.blocks\.(\d+)\.(.+)$", key)
    if m:
        i, j, rest = m.groups()
        if j not in _GD_SUBBLOCK:
            return None
        mod, ada = _GD_SUBBLOCK[j]
        if rest.startswith("adaLN_modulation."):
            return f"blocks.{i}.{ada}.{rest[len('adaLN_modulation.'):]}"
        if j in ("0", "1"):
            m2 = re.match(r"block\.attn\.(to_\w+\.\d)\.(weight|bias)$", rest)
            if m2 and m2.group(1) in _GD_ATTN:
                return f"blocks.{i}.{mod}.{_GD_ATTN[m2.group(1)]}.{m2.group(2)}"
            return None
        m2 = re.match(r"block\.(layer[12])\.(weight|bias)$", rest)
        return f"blocks.{i}.mlp.{m2.group(1)}.{m2.group(2)}" if m2 else None
    if key.startswith("blocks."):
        return None
    if key.startswith("affline_norm."):
        return "t_embedding_norm." + key[len("affline_norm."):]
    if key.startswith("final_layer.adaLN_modulation."):
        return "final_layer.adaln_modulation." + key[len("final_layer.adaLN_modulation."):]
    # x_embedder.proj.1, t_embedder.1.linear_{1,2} and final_layer.linear keep
    # their names; anything else is left to the keymap, which raises on it
    return key


def convert_general_dit_sd(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A Cosmos-1 GeneralDIT state dict (`net.` / `diffusion_model.`
    prefixes stripped or not) -> Predict2's names. The transformer-engine
    `_extra_state` blobs and the RoPE `seq` buffer are skipped; a block key
    that maps to no Predict2 name raises KeyError naming it."""
    out, unmapped = {}, []
    for k, v in sd.items():
        kk = k
        for p in ("model.diffusion_model.", "diffusion_model.", "net."):
            if kk.startswith(p):
                kk = kk[len(p):]
        if not skip_buffers({kk: v}):
            continue
        name = _general_dit_name(kk)
        if name is None:
            unmapped.append(k)
        else:
            out[name] = v
    if unmapped:
        raise KeyError(f"{len(unmapped)} Cosmos-1 GeneralDIT keys map to no Predict2 name, "
                       f"e.g. {unmapped[:5]}")
    return out


@register_model("cosmos")
class CosmosPipeline(CosmosPredict2Pipeline):
    name = "cosmos"
    framerate = 24
    SIZE_KNOBS = ("model_channels", "num_blocks", "num_heads")

    def published_layout(self) -> Dict[str, Any]:
        """Cosmos-1-7B: 4,096 wide, 28 blocks, 32 heads, adaLN-LoRA."""
        return dict(model_channels=4096, num_blocks=28, num_heads=32, use_adaln_lora=True)

    def lr_scale_map(self, base_lr) -> Dict[str, float]:
        return {}  # Cosmos-1 has no LR groups

    # --- training -------------------------------------------------------------

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None,
                       noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None):
        """batch: latents [B, 16, F, H, W] (or [B, 16, H, W]), prompt_embeds
        [B, L, 1,024], optional mask. EDM noise (t, when given, is sigma):
        the net input c_in x_t at t = c_noise; x_t and sigma ride along for
        the preconditioned output; the target is the clean latents."""
        latents = batch["latents"].to(self.device, torch.float32)
        if latents.dim() == 4:
            latents = latents[:, :, None]
        b, _, _, h, w = latents.shape
        mask = self._latent_mask(batch, b, h, w)
        net_in, x_t, c_noise, sigma = edm_noise(
            latents, generator, quantile=timestep_quantile,
            noise=None if noise is None else noise.reshape(latents.shape), sigma=t)
        inputs = dict(x=net_in.to(self.cp_config.dtype), t=c_noise,
                      context=batch["prompt_embeds"].to(self.device), _x_t=x_t, _sigma=sigma)
        return inputs, latents, mask

    def forward(self, model_inputs):
        """(x0 prediction c_skip x_t + c_out F in f32, sigma)."""
        mi = dict(model_inputs)
        x_t, sigma = mi.pop("_x_t"), mi.pop("_sigma")
        net_out = self.model(**mi)
        exp = (sigma.shape[0],) + (1,) * (x_t.dim() - 1)
        c_skip, c_out, _, _ = edm_scalings(sigma)
        return c_skip.reshape(exp) * x_t + c_out.reshape(exp) * net_out.float(), sigma

    def loss_fn(self, output, target, mask):
        """The masked MSE of the x0 prediction times the per-sigma weights."""
        x0, sigma = output
        loss = (x0.float() - target.float()) ** 2
        if mask is not None and mask.numel() > 0:
            loss = loss * mask.float().expand_as(loss)
        w = per_sigma_loss_weights(sigma)
        return torch.mean(loss * w.reshape((sigma.shape[0],) + (1,) * (loss.dim() - 1)))

    @staticmethod
    def karras_sigmas(num_steps: int, device=None) -> torch.Tensor:
        """[num_steps + 1] f32: the Karras schedule from 80 to 0.002 at rho
        7, then 0."""
        rho, s_min, s_max = 7.0, 0.002, 80.0
        i = torch.arange(num_steps, dtype=torch.float32, device=device)
        sigmas = (s_max ** (1 / rho) + i / max(num_steps - 1, 1)
                  * (s_min ** (1 / rho) - s_max ** (1 / rho))) ** rho
        return torch.cat([sigmas, torch.zeros(1, device=device)])

    @torch.no_grad()
    def sample(self, width: int, height: int, generator=None, num_steps: int = 20,
               guidance_scale: float = 1.0, noise: Optional[torch.Tensor] = None,
               num_frames: int = 1, **embeds):
        """EDM Euler sampling over the Karras schedule through the training
        forward: latents [B, 16, F, height/8, width/8] f32, F = (frames - 1)
        // 8 + 1, from N(0, 1) x 80 (noise, when given, is the unit draw)."""
        cfg = self.cp_config
        ctx = torch.as_tensor(embeds["prompt_embeds"]).to(self.device)
        b = ctx.shape[0]
        f = max(1, (int(num_frames) - 1) // 8 + 1)
        sigmas = self.karras_sigmas(num_steps, self.device)
        if noise is None:
            noise = torch.randn((b, cfg.in_channels, f, height // 8, width // 8),
                                generator=generator, dtype=torch.float32, device=self.device)
        x = noise.to(self.device, torch.float32) * sigmas[0]
        for i in range(num_steps):
            sig = sigmas[i].expand(b)
            c_skip, c_out, c_in, c_noise = edm_scalings(sig)
            exp = (b, 1, 1, 1, 1)
            net_out = self.model(x=(x * c_in.reshape(exp)).to(cfg.dtype), t=c_noise, context=ctx)
            x0 = c_skip.reshape(exp) * x + c_out.reshape(exp) * net_out.float()
            x = x + (sigmas[i + 1] - sigmas[i]) * (x - x0) / sigmas[i]
        return x

    # --- caching encoders -------------------------------------------------------

    def _load_vae(self):
        """The Cosmos tokenizer of model.vae_path on the pipeline's device in
        the model dtype, frozen (under `_tiny`, the tiny Wan VAE)."""
        if self.model_config.get("_tiny", False):
            return super()._load_vae()
        if getattr(self, "_vae", None) is None:
            from .cosmos_tokenizer import CosmosVideoTokenizer, convert_cosmos_tokenizer
            from .weights import load_state_dict_any

            mc = self.model_config
            if mc.get("vae_params_path"):
                raise NotImplementedError("model.vae_params_path (a flax msgpack file) is the "
                                          "JAX package's; name the checkpoint as vae_path")
            dtype = dtype_from_string(mc.get("dtype", "bfloat16"))
            cfg, sd = convert_cosmos_tokenizer(load_state_dict_any(mc["vae_path"]), dtype)
            with torch.device("meta"):
                tok = CosmosVideoTokenizer(cfg)
            tok = tok.to_empty(device=self.device)
            tok.load_state_dict(sd)
            self._vae = tok.eval().requires_grad_(False)
        return self._vae

    def get_call_text_encoder_fns(self):
        """[fn]: captions -> {"prompt_embeds": old-T5-XXL's last states [B,
        512, 1,024] f32, the padded rows zeroed}; under `_tiny`, the JAX
        hook's seeded draws [8, ctx]."""
        from .text_encoders import HFTextEncoder

        mc = self.model_config
        if mc.get("_tiny", False):
            te = self._tiny_text_fn()
            return [lambda captions: {"prompt_embeds": te(captions)["t5_embed"]}]
        te_dtype = dtype_from_string(mc.get("text_encoder_dtype") or mc.get("dtype", "bfloat16"))
        enc = HFTextEncoder("t5", mc["t5_path"], max_length=512, device=self.device,
                            dtype=te_dtype)

        def fn(captions):
            h, m = enc.encode(captions, return_mask=True)
            return {"prompt_embeds": h * m[..., None].to(h.dtype)}

        return [fn]

    # --- weights ----------------------------------------------------------------

    def _raw_checkpoint(self):
        sd = super()._raw_checkpoint()
        if any(k.startswith("blocks.block") for k in sd):
            sd = convert_general_dit_sd(sd)
        return sd

