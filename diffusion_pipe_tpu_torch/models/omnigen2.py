"""OmniGen2 (text to image): the Lumina 2 transformer at OmniGen2's layout,
with Qwen2.5-VL captions and diffusers' key names.

Counterpart of diffusion_pipe_tpu/models/omnigen2.py: width 2,520, 32
main blocks and 2 + 2 refiners, 21 heads of 120 over 7 kv heads, RoPE axes
(40, 40, 40), Qwen2.5-VL-7B's final hidden state (3,584 wide) over up to
model.max_sequence_length (256) plain captions, cached as prompt_embeds /
prompt_attention_mask, and t scaled by 1,000. The reference trains it with
no reference image, so the reference-image branch (ref_image_patch_embedder,
ref_image_refiner, image_index_embedding) is not built: a checkpoint's
tensors of it pass through the load and a full fine-tuning export.

The KeyMap is diffusers' OmniGen2Transformer2DModel: separate to_q / to_k /
to_v, LuminaRMSNormZero's norm1.linear and norm1.norm, LuminaFeedForward's
linear_1 / 2 / 3, the time_caption_embed embedders and the norm_out head.
"""

from __future__ import annotations

from typing import Any, Dict

from . import register_model
from .lumina_2 import Lumina2Config, Lumina2Pipeline

PUBLISHED = dict(dim=2520, num_layers=32, num_refiner_layers=2, num_heads=21, num_kv_heads=7,
                 cap_dim=3584, axes_dims_rope=(40, 40, 40))

OMNIGEN2_LINEARS = {"attn_wq": "attn.to_q", "attn_wk": "attn.to_k", "attn_wv": "attn.to_v",
                    "attn_wo": "attn.to_out.0", "ffn_w1": "feed_forward.linear_1",
                    "ffn_w2": "feed_forward.linear_2", "ffn_w3": "feed_forward.linear_3"}
OMNIGEN2_NORMS = {"attn_q_norm": "attn.norm_q", "attn_k_norm": "attn.norm_k",
                  "attention_norm2": "norm2", "ffn_norm1": "ffn_norm1", "ffn_norm2": "ffn_norm2"}
OMNIGEN2_TOP = {"x_embedder": "x_embedder",
                "t_embedder_1": "time_caption_embed.timestep_embedder.linear_1",
                "t_embedder_2": "time_caption_embed.timestep_embedder.linear_2",
                "cap_embedder": "time_caption_embed.caption_embedder.1",
                "final_adaLN": "norm_out.linear_1", "final_linear": "norm_out.linear_2"}


def omnigen2_keymap(cfg: Lumina2Config):
    """diffusers OmniGen2Transformer2DModel keys <-> the port's names (the
    JAX KeyMap's torch paths); LoRA in the ComfyUI dialect."""
    from .keymaps import BlockGroup, KeyMap

    ada = dict(linears={**OMNIGEN2_LINEARS, "adaLN_modulation": "norm1.linear"},
               norms={**OMNIGEN2_NORMS, "attention_norm1": "norm1.norm"})
    plain = dict(linears=OMNIGEN2_LINEARS, norms={**OMNIGEN2_NORMS, "attention_norm1": "norm1"})
    return KeyMap(
        blocks=[BlockGroup("layers", "layers", "num_layers", **ada),
                BlockGroup("context_refiner", "context_refiner", "num_refiner_layers", **plain),
                BlockGroup("noise_refiner", "noise_refiner", "num_refiner_layers", **ada)],
        top_linears=OMNIGEN2_TOP,
        top_norms={"cap_embedder_norm": "time_caption_embed.caption_embedder.0"},
        lora_prefix="diffusion_model.",
        passthrough_patterns=(r"^ref_image_patch_embedder\.", r"^ref_image_refiner\.",
                              r"^image_index_embedding"))


@register_model("omnigen2")
class OmniGen2Pipeline(Lumina2Pipeline):
    name = "omnigen2"
    text_keys = ("prompt_embeds", "prompt_attention_mask")
    text_hidden_layer = -1

    def family_kwargs(self) -> Dict[str, Any]:
        return dict(time_scale=1000.0)

    def published_layout(self) -> Dict[str, Any]:
        return dict(PUBLISHED)

    def _max_length(self) -> int:
        return int(self.model_config.get("max_sequence_length", 256))

    def keymap(self):
        return omnigen2_keymap(self.lumina_config)
