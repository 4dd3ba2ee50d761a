"""TOML config surface, the port's own copy of diffusion_pipe_tpu/config.py.

Loads a training TOML and applies the same defaults and validation, so a
config file drives both packages alike. Dtypes stay canonical strings in the
dict; call sites map them with common.dtype_from_string.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import tomllib

from .common import DTYPE_MAP

_CANONICAL_DTYPE = {
    "fp32": "float32",
    "fp16": "float16",
    "bf16": "bfloat16",
    "float8": "float8_e4m3fn",
}


def _canon_dtype(name: str) -> str:
    if name not in DTYPE_MAP:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(DTYPE_MAP)}")
    return _CANONICAL_DTYPE.get(name, name)


def load_toml(path: str) -> Dict[str, Any]:
    """Load TOML and round-trip it through JSON (plain dicts and lists only)."""
    with open(path, "rb") as f:
        cfg = tomllib.load(f)
    return json.loads(json.dumps(cfg))


def set_config_defaults(config: Dict[str, Any]) -> Dict[str, Any]:
    """Apply defaults and validation, as the JAX package's set_config_defaults."""
    if not (
        "save_every_n_epochs" in config
        or "save_every_n_steps" in config
        or "save_every_n_examples" in config
    ):
        raise ValueError(
            "config must set one of save_every_n_epochs / save_every_n_steps / "
            "save_every_n_examples"
        )

    config.setdefault("pipeline_stages", 1)
    config.setdefault("tensor_parallel", 1)
    config.setdefault("fsdp_shard", False)
    config.setdefault("activation_checkpointing", False)
    config.setdefault("warmup_steps", 0)
    if "save_dtype" in config:
        config["save_dtype"] = _canon_dtype(config["save_dtype"])

    model_config = config["model"]
    model_dtype_str = _canon_dtype(model_config["dtype"])
    model_config["dtype"] = model_dtype_str
    for key in ("transformer_dtype", "diffusion_model_dtype", "text_encoder_dtype"):
        if model_config.get(key):
            model_config[key] = _canon_dtype(model_config[key])
    model_config.setdefault("guidance", 1.0)
    if model_config.get("int8_matmul") and "adapter" not in config:
        raise ValueError(
            "model.int8_matmul requires an [adapter] (LoRA/LoKr): the int8 "
            "base kernels are frozen and receive no gradients. Remove "
            "int8_matmul for full fine-tuning."
        )

    if "adapter" in config:
        adapter_config = config["adapter"]
        adapter_type = adapter_config["type"]
        if "alpha" in adapter_config:
            raise NotImplementedError(
                "alpha is forced equal to rank; remove alpha from the config"
            )
        adapter_config["alpha"] = adapter_config["rank"]
        adapter_config.setdefault("dtype", model_dtype_str)
        adapter_config["dtype"] = _canon_dtype(adapter_config["dtype"])
        if adapter_type == "lora":
            adapter_config.setdefault("dropout", 0.0)
        elif adapter_type == "lokr":
            adapter_config.setdefault("decompose_factor", -1)
            adapter_config.setdefault("rank_dropout", 0.0)
        else:
            raise NotImplementedError(f"Adapter type {adapter_type} is not implemented")

    config.setdefault("logging_steps", 1)
    config.setdefault("eval_datasets", [])
    config.setdefault("eval_gradient_accumulation_steps", 1)
    config.setdefault("eval_every_n_steps", None)
    config.setdefault("eval_every_n_epochs", None)
    config.setdefault("eval_every_n_examples", None)
    config.setdefault("eval_before_first_step", True)
    config.setdefault("x_axis_examples", False)
    config.setdefault("gradient_accumulation_steps", 1)
    config.setdefault("gradient_clipping", 1.0)
    config.setdefault("steps_per_print", 1)
    config.setdefault("caching_batch_size", 1)
    config.setdefault("seed", 0)
    config.setdefault("optimizer", {"type": "adamw"})
    return config


def normalize_batch_size_map(value) -> Dict[Optional[int], int]:
    """micro_batch_size_per_gpu as a {resolution: bs} map: an int applies to
    every resolution (key None); a list holds [resolution, bs] pairs."""
    if value is None:
        return {None: 1}
    if isinstance(value, int):
        return {None: value}
    if isinstance(value, dict):
        return {(None if k in (None, "default") else int(k)): int(v)
                for k, v in value.items()}
    return {int(x[0]): int(x[1]) for x in value}


def lookup_batch_size(bs_map: Dict[Optional[int], int], resolution) -> int:
    """The micro batch size for a bucket resolution: the exact key, else the
    largest configured resolution <= the bucket's, else the default."""
    if resolution in bs_map:
        return bs_map[resolution]
    keyed = sorted(k for k in bs_map if k is not None)
    chosen = None
    for k in keyed:
        if resolution is not None and k <= resolution:
            chosen = k
    if chosen is not None:
        return bs_map[chosen]
    if None in bs_map:
        return bs_map[None]
    return bs_map[keyed[0]]


def resolve_batch_size_maps(config: Dict[str, Any]) -> Dict[str, Dict]:
    """The four batch-size maps: train / eval x any / image buckets."""
    mbs = normalize_batch_size_map(config.get("micro_batch_size_per_gpu", 1))
    eval_mbs = (
        normalize_batch_size_map(config["eval_micro_batch_size_per_gpu"])
        if "eval_micro_batch_size_per_gpu" in config
        else mbs
    )
    image_mbs = (
        normalize_batch_size_map(config["image_micro_batch_size_per_gpu"])
        if "image_micro_batch_size_per_gpu" in config
        else mbs
    )
    eval_image_mbs = (
        normalize_batch_size_map(config["eval_image_micro_batch_size_per_gpu"])
        if "eval_image_micro_batch_size_per_gpu" in config
        else eval_mbs
    )
    return {"train": mbs, "eval": eval_mbs, "image": image_mbs,
            "eval_image": eval_image_mbs}


def load_config(path: str) -> Dict[str, Any]:
    config = load_toml(path)
    set_config_defaults(config)
    config["_config_path"] = os.path.abspath(path)
    return config
