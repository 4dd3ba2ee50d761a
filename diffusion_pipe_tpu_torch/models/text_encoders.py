"""Text-encoder wrappers for the caching phase: transformers' torch T5 and
CLIP text models, and the fp8 storage of a text encoder's weights.

Counterpart of diffusion_pipe_tpu/models/text_encoders.py, which runs the
Flax classes; here T5EncoderModel and CLIPTextModel run on the pipeline's
device. transformers is imported when an encoder first loads, so the port
imports without it. Weights and tokenizers load from the same
diffusers-layout folders as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

_FP8_SKIP = ("shared", "embed_tokens", "relative_attention_bias", "token_embedding",
             "pos_embedding", "position_embedding", "embedding", "lm_head")


def cast_te_params_fp8(sd: Mapping[str, torch.Tensor],
                       skip=_FP8_SKIP) -> Dict[str, torch.Tensor]:
    """`text_encoder_fp8`: every 2-D floating weight of a text encoder's
    state dict whose name holds none of `skip` (the embeddings and
    relative-position tables) stored as float8_e4m3fn, the rest unchanged.
    The encoder casts such a weight back to its compute dtype at use. The
    same tensors as the JAX function casts, by the same rule on the
    parameter path."""
    return {k: (v.to(torch.float8_e4m3fn)
                if v.dim() == 2 and v.is_floating_point() and not any(s in k for s in skip)
                else v)
            for k, v in sd.items()}


class _Fp8Linear(torch.nn.Module):
    """A linear whose weight is stored in float8_e4m3fn, cast to the input's
    dtype at use."""

    def __init__(self, linear: torch.nn.Linear):
        super().__init__()
        self.weight = torch.nn.Parameter(linear.weight.detach().to(torch.float8_e4m3fn),
                                         requires_grad=False)
        self.bias = linear.bias

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return torch.nn.functional.linear(x, self.weight.to(x.dtype), bias)


def store_linears_fp8(model: torch.nn.Module, skip=_FP8_SKIP) -> int:
    """`text_encoder_fp8` for a transformers model: every nn.Linear whose
    name holds none of `skip` replaced in place by one with its weight in
    float8_e4m3fn (the weights cast_te_params_fp8 casts), but the modules
    the model keeps in f32 (its `_keep_in_fp32_modules`: T5's feed-forward
    `wo`, whose input it casts to the weight's dtype). Returns the count."""
    keep = set(getattr(model, "_keep_in_fp32_modules", None) or ())
    names = [n for n, m in model.named_modules()
             if isinstance(m, torch.nn.Linear) and not any(s in n for s in skip)
             and n.rpartition(".")[2] not in keep]
    for name in names:
        owner, _, leaf = name.rpartition(".")
        parent = model.get_submodule(owner) if owner else model
        setattr(parent, leaf, _Fp8Linear(getattr(parent, leaf)))
    return len(names)


def seeded_draws(captions: List[str], suffix: str, shape) -> torch.Tensor:
    """[B, *shape] f32: each caption's normal draws from numpy's generator
    seeded with the hash of caption + suffix, the JAX `_tiny` hooks' values
    (the stand-ins of a text encoder under `_tiny`)."""
    import numpy as np

    from ..data.bucketing import seed_from_hash

    return torch.from_numpy(np.stack([
        np.random.default_rng(seed_from_hash(c + suffix)).standard_normal(shape).astype(np.float32)
        for c in captions]))


def seeded_caption_draws(captions: List[str], rows: int, width: int):
    """([B, rows, width] f32, [B, rows] int32): the JAX `_tiny` text hooks'
    masked draws, min(len(caption) + 1, rows) valid rows of normal draws
    from numpy's generator seeded with the caption's hash, zeros after."""
    import numpy as np

    from ..data.bucketing import seed_from_hash

    embs = np.zeros((len(captions), rows, width), np.float32)
    masks = np.zeros((len(captions), rows), np.int32)
    for i, c in enumerate(captions):
        n = min(len(c) + 1, rows)
        embs[i, :n] = np.random.default_rng(seed_from_hash(c)).standard_normal((n, width))
        masks[i, :n] = 1
    return torch.from_numpy(embs), torch.from_numpy(masks)


def _model_type(path) -> str:
    """config.json's model_type of a transformers folder ("" without one)."""
    import json
    from pathlib import Path

    cfg = Path(path) / "config.json"
    return json.loads(cfg.read_text()).get("model_type", "") if cfg.is_file() else ""


class HFTextEncoder:
    """Lazy wrapper around a transformers torch text encoder.

    kind: 't5' | 'clip' | 'clip_pooled'; path: a folder with the weights
    (tokenizer_path overrides where the tokenizer is); a 't5' folder whose
    config names umt5 (Pile-T5) loads UMT5's encoder; with fp8 its linears
    are stored in float8 (store_linears_fp8). encode(captions)
    returns the last hidden state [B, max_length, D] (or CLIP's pooled
    output [B, D]) as f32 CPU tensors.
    """

    def __init__(self, kind: str, path: str, max_length: int,
                 tokenizer_path: Optional[str] = None, device=None,
                 dtype: torch.dtype = torch.float32, fp8: bool = False):
        if kind not in ("t5", "clip", "clip_pooled"):
            raise NotImplementedError(kind)
        self.kind = kind
        self.path = path
        self.max_length = max_length
        self.tokenizer_path = tokenizer_path or path
        self.device = device
        self.dtype = dtype
        self.fp8 = fp8
        self._model = None
        self._tokenizer = None

    def _load(self):
        if self._model is not None:
            return
        from transformers import AutoTokenizer

        self._tokenizer = AutoTokenizer.from_pretrained(self.tokenizer_path)
        if self.kind == "t5" and _model_type(self.path) == "umt5":
            # Pile-T5 (AuraFlow's) and UMT5 checkpoints: UMT5's encoder
            from transformers import UMT5EncoderModel as cls
        elif self.kind == "t5":
            from transformers import T5EncoderModel as cls
        else:
            from transformers import CLIPTextModel as cls
        self._model = cls.from_pretrained(self.path, dtype=self.dtype).to(self.device).eval()
        if self.fp8:
            store_linears_fp8(self._model)

    @torch.no_grad()
    def encode(self, captions: List[str], return_mask: bool = False):
        """The embeddings; with return_mask, (embeddings, the tokenizer's
        attention mask [B, max_length] int64)."""
        self._load()
        tok = self._tokenizer(captions, padding="max_length", truncation=True,
                              max_length=self.max_length, return_tensors="pt")
        ids = tok["input_ids"].to(self.device)
        mask = tok["attention_mask"].to(self.device)
        out = self._model(input_ids=ids, attention_mask=mask)
        emb = out.pooler_output if self.kind == "clip_pooled" else out.last_hidden_state
        if return_mask:
            return emb.float().cpu(), tok["attention_mask"]
        return emb.float().cpu()
