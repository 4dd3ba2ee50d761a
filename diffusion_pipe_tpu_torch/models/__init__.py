"""Model plugins: the registry maps `model.type` strings to pipeline classes.

Counterpart of diffusion_pipe_tpu/models/__init__.py; so far the Flux family,
Wan (t2v, i2v, flf2v, i2v_v2 and ti2v), SDXL, SD3 / SD3.5, Chroma,
Qwen-Image / Qwen-Image-Edit, FLUX.2 and AuraFlow are ported.
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
    from . import auraflow, chroma, flux, flux2, qwen_image, sd3, sdxl, wan  # noqa: F401

    if name not in _REGISTRY:
        raise NotImplementedError(f"model type {name!r} is not ported yet (ROADMAP A9)")
    return _REGISTRY[name]
