"""The port's Qwen2.5-VL vision tower vs the JAX package and transformers.

A tiny random transformers Qwen2_5_VisionTransformerPretrainedModel (2
blocks, 32 wide, 4 heads, a 56 px window: 2 x 2 merged tokens, so the
8 x 12 patch grid makes six windows), its norm scales and biases perturbed;
its state dict goes through the JAX convert_hf_qwen_vision and the port's.
Two layouts: block 1 full and block 0 windowed, and both full. Tolerances
(f32): the port against the JAX tower 2e-5 and against transformers 1e-4
(the merged tokens [24, 24]). qwen_vl_rope_index, image_to_qwen_patches,
rot_pos_ids and window_index are numpy and equal the JAX functions
exactly; the rope index also equals transformers' get_rope_index on the
one-image case.
"""

import functools
import os

os.environ.setdefault("USE_TF", "0")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from diffusion_pipe_tpu.models import vision_encoders as jve  # noqa: E402
from diffusion_pipe_tpu_torch.interop import tree_to_state_dict  # noqa: E402
from diffusion_pipe_tpu_torch.models import vision_encoders as tve  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_helpers import JAX_FAST_COMPILE  # noqa: E402

GRID = (1, 8, 12)
VISION = dict(depth=2, hidden_size=32, intermediate_size=48, num_heads=4, out_hidden_size=24,
              patch_size=14, temporal_patch_size=2, spatial_merge_size=2, window_size=56)


def hf_tower(full):
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import Qwen2_5_VLVisionConfig
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import (
        Qwen2_5_VisionTransformerPretrainedModel)

    cfg = Qwen2_5_VLVisionConfig(**VISION, fullatt_block_indexes=full)
    cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = Qwen2_5_VisionTransformerPretrainedModel(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape))
    return model, {**VISION, "fullatt_block_indexes": list(full)}


@functools.partial(jax.jit, static_argnums=0, compiler_options=JAX_FAST_COMPILE)
def _jax_tower(cfg, params, pixels):
    return jve.QwenVLVisionTower(cfg, (GRID,)).apply(params, pixels)


@pytest.mark.parametrize("full", [(1,), (0, 1)], ids=["windowed", "full"])
def test_vision_tower_matches_jax_and_transformers(full):
    model, hf_cfg = hf_tower(full)
    sd = model.state_dict()
    pixels = np.random.default_rng(1).standard_normal((96, 3 * 2 * 14 * 14)).astype(np.float32)

    jcfg = jve.QwenVLVisionConfig.from_hf_config(hf_cfg)
    jparams = jve.convert_hf_qwen_vision(sd, jcfg, prefix="")
    want = np.asarray(_jax_tower(jcfg, jparams, jnp.asarray(pixels)))

    tcfg = tve.QwenVLVisionConfig.from_hf_config(hf_cfg)
    tower = tve.QwenVLVisionTower(tcfg)
    tower.load_state_dict(tve.convert_hf_qwen_vision(sd, tcfg, prefix=""))
    assert set(tree_to_state_dict(jax.tree.map(np.asarray, jparams))) == set(tower.state_dict())
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels), (GRID,)).numpy()
        hf = model(torch.from_numpy(pixels), grid_thw=torch.tensor([GRID])).numpy()
    assert got.shape == (24, 24)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, hf, atol=1e-4, rtol=1e-4)


def test_rope_index_patches_and_windows_match_jax():
    ids = np.array([5, 6, 7] + [99] * 24 + [8, 9, 0, 0])
    got = tve.qwen_vl_rope_index(ids, 99, GRID, merge=2)
    np.testing.assert_array_equal(got, jve.qwen_vl_rope_index(ids, 99, GRID, merge=2))
    # the text after the image resumes at start + max(t, h, w)
    assert got[:, 27].tolist() == [3 + 6] * 3

    from transformers import Qwen2_5_VLConfig
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import Qwen2_5_VLModel

    cfg = Qwen2_5_VLConfig(text_config=dict(vocab_size=128, hidden_size=16, num_hidden_layers=1,
                                            num_attention_heads=2, num_key_value_heads=1,
                                            intermediate_size=16),
                           vision_config=dict(depth=1, hidden_size=16, num_heads=2,
                                              out_hidden_size=16, intermediate_size=16),
                           image_token_id=99, vision_start_token_id=7, video_token_id=98)
    with torch.device("meta"):
        hf = Qwen2_5_VLModel(cfg)
    pos, _ = hf.get_rope_index(torch.from_numpy(ids)[None], torch.tensor([GRID]),
                               attention_mask=torch.ones(1, len(ids), dtype=torch.long))
    np.testing.assert_array_equal(got[:, :29], pos[:, 0, :29].numpy())

    img = np.random.default_rng(2).uniform(-1, 1, (3, 112, 168)).astype(np.float32)
    p, grid = tve.image_to_qwen_patches(img)
    jp, jgrid = jve.image_to_qwen_patches(img)
    assert grid == jgrid == GRID
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(tve.rot_pos_ids((GRID,), 2), jve.rot_pos_ids((GRID,), 2))
    for a, b in zip(tve.window_index((GRID,), 56, 2, 14), jve.window_index((GRID,), 56, 2, 14)):
        np.testing.assert_array_equal(a, b)
