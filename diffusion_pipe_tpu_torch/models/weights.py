"""Weight files: safetensors loading, ComfyUI fp8 dequantization, torch
pickles, and LoRA merges into a raw state dict.

Counterpart of diffusion_pipe_tpu/models/weights.py, on torch tensors:
safetensors files are read through ..safetensors_io, so the `safetensors`
package is not needed.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Mapping, Sequence

import torch

from .. import safetensors_io

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


class TrackedDict(dict):
    """A checkpoint's tensors that record which keys a converter reads: a
    key it lacks raises KeyError naming it, and check_all_read raises,
    naming them, on the keys no read took (outside the `passthrough`
    regexes), so that a checkpoint of another layout does not load by
    halves. Membership tests do not count as reads."""

    def __init__(self, sd: Mapping[str, torch.Tensor], what: str = "checkpoint"):
        super().__init__(sd)
        self.what, self.read = what, set()

    def __getitem__(self, key):
        if not dict.__contains__(self, key):
            raise KeyError(f"{self.what} lacks {key!r}")
        self.read.add(key)
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        return self[key] if key in self else default

    def check_all_read(self, passthrough: Sequence[str] = ()) -> None:
        left = sorted(k for k in self if k not in self.read
                      and not any(re.search(p, k) for p in passthrough))
        if left:
            raise KeyError(f"{self.what}: {len(left)} keys that the model does not take, "
                           f"e.g. {left[:8]}")


def take(sd: Mapping[str, torch.Tensor], pairs,
         what: str = "checkpoint") -> Dict[str, torch.Tensor]:
    """{ours: sd[theirs]} over (ours, theirs) pairs, raising KeyError that
    names every missing key and every key of sd left over."""
    pairs = list(pairs)
    missing = [theirs for _, theirs in pairs if theirs not in sd]
    if missing:
        raise KeyError(f"{what} lacks {len(missing)} keys, e.g. {missing[:8]}")
    tracked = TrackedDict(sd, what)
    out = {ours: tracked[theirs] for ours, theirs in pairs}
    tracked.check_all_read()
    return out


def load_safetensors_dir(path) -> Dict[str, torch.Tensor]:
    """Every *.safetensors of a file-or-directory path in one dict."""
    path = str(path)
    files = [path] if os.path.isfile(path) else sorted(
        glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors found at {path}")
    out: Dict[str, torch.Tensor] = {}
    for f in files:
        out.update(safetensors_io.load_file(f))
    return out


def dequantize_comfy_fp8(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Dequantize a ComfyUI fp8 checkpoint at load: a marker tensor named
    `scaled_fp8`, fp8 `X.weight` tensors with per-tensor `X.scale_weight`
    factors and optional `X.scale_input` (inference only). w = f32(w) *
    scale_weight, as bf16; fp8 tensors without a scale upcast unchanged. No
    fp8 tensor: the dict is returned as it is."""
    if not any(v.dtype in _FP8 for v in sd.values()):
        return sd
    out = {}
    for k, v in sd.items():
        base = k.rsplit(".", 1)[0] if "." in k else k
        if k.endswith(("scaled_fp8", ".scale_weight", ".scale_input")):
            continue
        if v.dtype in _FP8:
            w = v.float()
            scale = sd.get(f"{base}.scale_weight")
            if scale is not None and k.endswith(".weight"):
                w = w * scale.float().reshape((-1,) + (1,) * (w.dim() - 1))
            out[k] = w.to(torch.bfloat16)
        else:
            out[k] = v
    return out


def load_state_dict_any(path) -> Dict[str, torch.Tensor]:
    """A checkpoint that is safetensors or a torch pickle
    (.pt/.pth/.bin/.ckpt, a "state_dict" entry unwrapped)."""
    p = str(path)
    if os.path.isfile(p) and p.endswith((".pt", ".pth", ".bin", ".ckpt")):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
            sd = sd["state_dict"]
        return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    return load_safetensors_dir(p)


_KOHYA_PREFIXES = ("lora_unet_", "lora_te1_", "lora_te2_", "lora_te_")


def merge_adapters_into_state_dict(sd: Dict[str, torch.Tensor],
                                   adapter_paths) -> Dict[str, torch.Tensor]:
    """`model.merge_adapters = [path, ...]`: fuse LoRA files into a raw
    (torch-layout) state dict before conversion, W += (alpha / r) up @ down.
    Takes the ComfyUI (`lora_A`/`lora_B`, `lora_down`/`lora_up`) and kohya
    (`.alpha`, `lora_unet_` names with `_` separators) dialects; keys match
    the base dict with `diffusion_model.` / `transformer.` prefixes
    stripped or added."""
    if not adapter_paths:
        return sd
    sd = dict(sd)
    und_index = {k[: -len(".weight")].replace(".", "_"): k for k in sd if k.endswith(".weight")}
    for path in adapter_paths:
        lora = load_safetensors_dir(path)
        down_keys = [k for k in lora if ".lora_down." in k or ".lora_A." in k
                     or k.endswith("lora_down.weight") or k.endswith("lora_A.weight")]
        merged = skipped = 0
        for dk in down_keys:
            uk = dk.replace("lora_down", "lora_up").replace("lora_A", "lora_B")
            if uk not in lora:
                continue
            stem = dk
            for tok in (".lora_down.weight", ".lora_A.weight", ".lora_down", ".lora_A"):
                if tok in stem:
                    stem = stem.split(tok)[0]
                    break
            down, up = lora[dk].float(), lora[uk].float()
            rank = down.shape[0]
            alpha_key = stem + ".alpha"
            scale = float(lora[alpha_key]) / rank if alpha_key in lora else 1.0
            candidates = [stem + ".weight", stem,
                          stem.replace("diffusion_model.", "") + ".weight",
                          stem.replace("transformer.", "") + ".weight",
                          "model.diffusion_model." + stem + ".weight"]
            target = next((c for c in candidates if c in sd), None)
            if target is None:
                for p in _KOHYA_PREFIXES:
                    if stem.startswith(p):
                        target = und_index.get(stem[len(p):])
                        break
            if target is None:
                skipped += 1
                continue
            w = sd[target].float()
            delta = (up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)) * scale
            sd[target] = (w + delta.reshape(w.shape)).to(sd[target].dtype)
            merged += 1
        print(f"merge_adapters: fused {merged} LoRA pairs from {path}")
        if skipped:
            print(f"WARNING: merge_adapters: {skipped} LoRA pairs in {path} "
                  "matched no base weight and were skipped")
        if merged == 0:
            raise ValueError(f"merge_adapters: no LoRA pair in {path} matched any base "
                             "weight -- wrong model or unsupported key dialect")
    return sd
