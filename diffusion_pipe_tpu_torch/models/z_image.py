"""Z-Image (Tongyi's 6 B single-stream NextDiT): the Lumina 2 transformer at
Z-Image's layout, with Qwen3 captions.

Counterpart of diffusion_pipe_tpu/models/z_image.py: caption rows on RoPE
axis 0 from 1 and the image tokens at cap_len + 1 (rope_cap_offset 1),
learned image pad tokens up to a multiple of 32 (model.pad_tokens_multiple,
0 turning them off), Qwen3's final hidden state (hidden_layer -1) over up to
model.max_sequence_length (512) tokens, cached as text_embeds_0 /
attention_mask_0, and t scaled by 1,000.

Where the port departs from the JAX module, on purpose (the published
Z-Image, as diffusers' transformer_z_image.py and ComfyUI's NextDiT build
it):
- its RoPE has axes (32, 48, 48) at theta 256, which sum to the head dim
  of 128; the JAX pipeline never sets axes_dims_rope, so it keeps Lumina's
  (32, 32, 32), a 48-wide table against 64 rotary pairs, and its model
  fails at any head dim but 96. The JAX layout is reached only through
  interop.lumina2_config with axes that sum to its head dim;
- its defaults are the published model's: width 3,840, 30 main blocks and
  2 + 2 refiners, 30 heads with no grouping (30 kv heads), Qwen3-4B's 2,560
  caption width, a 256-wide timestep embedding from a 1,024-wide MLP
  (min(dim, 256) and mid_size 1,024); the JAX defaults (3,072 wide, 24
  heads, 8 kv heads, min(dim, 1,024)) are not the 6 B model. A checkpoint's
  keys decide the layout when [model] names one.
"""

from __future__ import annotations

from typing import Any, Dict

from . import register_model
from .lumina_2 import Lumina2Pipeline

# the released Z-Image's transformer (and the JAX tiny hook's RoPE at `_tiny`)
PUBLISHED = dict(dim=3840, num_layers=30, num_refiner_layers=2, num_heads=30, num_kv_heads=30,
                 cap_dim=2560, axes_dims_rope=(32, 48, 48), rope_theta=256.0, adaln_dim=256,
                 time_mid_dim=1024)


@register_model("z_image")
class ZImagePipeline(Lumina2Pipeline):
    name = "z_image"
    text_keys = ("text_embeds_0", "attention_mask_0")
    text_hidden_layer = -1

    def family_kwargs(self) -> Dict[str, Any]:
        return dict(time_scale=1000.0, rope_cap_offset=1,
                    pad_tokens_multiple=self.model_config.get("pad_tokens_multiple", 32) or None)

    def published_layout(self) -> Dict[str, Any]:
        return dict(PUBLISHED)

    def _max_length(self) -> int:
        return int(self.model_config.get("max_sequence_length", 512))
