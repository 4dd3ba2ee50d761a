"""Model plugins: the registry maps `model.type` strings to pipeline classes.

Counterpart of diffusion_pipe_tpu/models/__init__.py; so far the Flux family,
Wan (t2v, i2v, flf2v, i2v_v2 and ti2v), SDXL, SD3 / SD3.5, Chroma,
Qwen-Image / Qwen-Image-Edit, FLUX.2, AuraFlow, the Lumina 2 family
(lumina_2 / lumina2, z_image, omnigen2), HiDream-I1, Cosmos-Predict2 and
Anima (cosmos_predict2 / anima), Cosmos-1 (cosmos), HunyuanVideo
(hunyuan-video / hunyuan_video), HunyuanImage-2.1 (hunyuan_image),
HunyuanVideo-1.5 (hunyuan_video_15 / hunyuan_video_1.5), LTX-Video
(ltx-video / ltx_video) and LTX-2's video path (ltx2) are ported.
"""

from typing import Dict

_REGISTRY: Dict[str, type] = {}


def register_model(name: str, *aliases: str):
    def deco(cls):
        _REGISTRY[name] = cls
        for a in aliases:
            _REGISTRY[a] = cls
        return cls

    return deco


def get_model_class(name: str):
    from . import (auraflow, chroma, cosmos, cosmos_predict2, flux, flux2, hidream,  # noqa: F401
                   hunyuan_image, hunyuan_video, hunyuan_video_15, lumina_2, ltx2, ltx_video,
                   omnigen2, qwen_image, sd3, sdxl, wan, z_image)

    if name not in _REGISTRY:
        raise NotImplementedError(f"model type {name!r} is not ported yet (ROADMAP A9)")
    return _REGISTRY[name]
