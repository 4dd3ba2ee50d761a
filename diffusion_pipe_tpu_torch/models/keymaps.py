"""Declarative weight-key maps: torch checkpoints <-> the port's state dicts,
and adapter export and import.

Counterpart of diffusion_pipe_tpu/models/keymaps.py. One KeyMap for each
family drives checkpoint loading, the LoRA / LoKr export, the adapter
import of `adapter.init_from_existing` and the full fine-tuning export. The
JAX package's target is a Flax tree; the port's is its own state dict:

  - a block group's slot i is `{flax_key}.{i}.<leaf path with '.'>`
    (`blocks.{i}.attn_to_q.weight`, `double_blocks.{i}.ff_in.bias`), a
    top-level leaf path becomes a dotted name (`timestep_embedder.linear_1`);
  - a linear keeps torch's [out, in] `weight` and its `bias`; a norm's
    `.weight` or `.scale` (norm_suffix) becomes `.scale`; `raw` tensors keep
    their layout;
  - a `fused` torch linear splits along its out rows into several linears
    (equal parts, or the sizes given: BFL qkv, Chroma's linear1);
  - `stacks` keep the JAX leaf's [N, in, out] layout, `top_convs` torch's
    [out, in, *k];
  - a `top_patch_linears` conv [out, C, *k] becomes a linear [out,
    prod(k) * C] over (k..., C)-ordered flattened patches
    (`patch_linear_shapes` gives (C, *k) back).

So keymap_to_state_dict(sd) is jax_to_state_dict(keymap_to_flax(sd)) of the
port's interop.py, and keymap_from_state_dict inverts it.

Adapters: a linear's LoRA factors lora_a [in, r] / lora_b [r, out] go out
as `<lora_prefix><torch path>.lora_A.weight` [r, in] and `.lora_B.weight`
[out, r] in f32 (LoKr: `.lokr_w1`, `.lokr_w2` or `.lokr_w2_a` /
`.lokr_w2_b`, transposed), the JAX export's keys and bits. A fused entry's
n LoRA pairs go out as one pair of rank n * r on the fused torch weight: A
the row concatenation of the n A factors, B block-diagonal.
save_lora_safetensors writes such a pair's `.alpha` as n * alpha, so a
loader that scales a pair by alpha / rank (rank = lora_A's rows: ComfyUI,
kohya, merge_adapters_into_state_dict) applies the trained alpha / r; the
JAX package writes alpha for it and so applies 1/n of the trained delta.
The import splits such a pair back into its n factors and raises, naming
the key, when B is not block-diagonal. A fused entry's LoKr factors have
no single-weight form: they go out per part, under
`<torch path>.{j}.lokr_*` (part j of the fused rows), which only this
package reads back.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .weights import (TrackedDict, dequantize_comfy_fp8, load_safetensors_dir,
                      merge_adapters_into_state_dict)


@dataclasses.dataclass
class BlockGroup:
    """One run of identical blocks.

    linears: our leaf path -> torch submodule path (within the block).
    norms:   scale-only norms (torch `.weight` / `.scale` -> our `scale`).
    raw:     direct tensors (modulation tables); torch key used verbatim.
    fused:   torch submodule path -> (our leaf names...) split equally
             along the torch OUT dim (row blocks), or ((name, rows), ...).
    """

    flax_key: str
    prefix: str                       # e.g. "transformer_blocks"
    # config attr holding the block count, or a literal int
    num_layers_attr: Any = None
    # torch index base: our slot i <-> torch `{prefix}.{offset+i}`
    offset: int = 0
    linears: Dict[str, str] = dataclasses.field(default_factory=dict)
    norms: Dict[str, str] = dataclasses.field(default_factory=dict)
    raw: Dict[str, str] = dataclasses.field(default_factory=dict)
    fused: Dict[str, Tuple] = dataclasses.field(default_factory=dict)
    # stacked bias-free linears: our leaf -> (torch_subpath_fmt with one {}
    # slot, count | config attr); torch `{fmt.format(j)}.weight` [O, I]
    # stack to one [N, I, O] tensor (expert banks, per-index projections)
    stacks: Dict[str, Tuple[str, Any]] = dataclasses.field(default_factory=dict)
    # torch norm param suffix: "weight" (torch RMS/LN) or "scale" (BFL)
    norm_suffix: str = "weight"


@dataclasses.dataclass
class KeyMap:
    blocks: List[BlockGroup]
    top_linears: Dict[str, str] = dataclasses.field(default_factory=dict)
    top_norms: Dict[str, str] = dataclasses.field(default_factory=dict)
    top_raw: Dict[str, str] = dataclasses.field(default_factory=dict)
    # our path -> torch prefix for conv weights (layout kept)
    top_convs: Dict[str, str] = dataclasses.field(default_factory=dict)
    # patchify projection: torch Conv2d/3d [O, C, *k] <-> our linear
    # [O, prod(k) * C] applied to (k..., C)-ordered flattened patches
    top_patch_linears: Dict[str, str] = dataclasses.field(default_factory=dict)
    # required with top_patch_linears for inversion: our path -> (C, *k)
    patch_linear_shapes: Dict[str, Tuple[int, ...]] = dataclasses.field(default_factory=dict)
    # fused linears outside block groups: torch path -> entries (see
    # BlockGroup.fused); the names here are full '/'-joined paths
    top_fused: Dict[str, Tuple] = dataclasses.field(default_factory=dict)
    # stacked bias-free linears outside blocks (see BlockGroup.stacks)
    top_stacks: Dict[str, Tuple[str, Any]] = dataclasses.field(default_factory=dict)
    top_norm_suffix: str = "weight"
    lora_prefix: str = "diffusion_model."
    strip_prefixes: Sequence[str] = (
        "model.diffusion_model.", "diffusion_model.", "transformer.",
    )
    # regex patterns (re.search over prefix-stripped keys) naming checkpoint
    # tensors that no module of the port computes with: excluded from
    # conversion, kept on the pipeline at load, written back verbatim by
    # save_model so a full-model export stays a complete checkpoint
    passthrough_patterns: Sequence[str] = ()
    # (LoRA-file name, torch name) parts of a family's own LoRA dialect
    # (HunyuanImage-2.1's ComfyUI names): the export replaces each second
    # by its first in the keys, the import each first by its second
    lora_renames: Sequence[Tuple[str, str]] = ()


def _renamed(key: str, pairs) -> str:
    for old, new in pairs:
        key = key.replace(old, new)
    return key


def _dotted(path: str) -> str:
    return path.replace("/", ".")


def strip_known_prefixes(sd: Mapping[str, Any], km: KeyMap) -> Dict[str, Any]:
    """Normalize wrapper prefixes; the first matching prefix is removed."""
    out = {}
    for k, v in sd.items():
        for p in km.strip_prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def split_passthrough(sd: Mapping[str, Any], km: KeyMap):
    """Partition a (stripped-key) state dict into (convertible,
    passthrough) per km.passthrough_patterns."""
    if not km.passthrough_patterns:
        return dict(sd), {}
    pats = [re.compile(p) for p in km.passthrough_patterns]
    main: Dict[str, Any] = {}
    keep: Dict[str, Any] = {}
    for k, v in sd.items():
        (keep if any(p.search(k) for p in pats) else main)[k] = v
    return main, keep


def count_blocks(sd: Mapping[str, Any], prefix: str) -> int:
    """How many `{prefix}.N.` blocks a (prefix-stripped) checkpoint holds,
    0 for none; indices that are not 0..n-1 raise KeyError."""
    idx = {int(m.group(1)) for k in sd
           for m in [re.match(re.escape(prefix) + r"\.(\d+)\.", k)] if m}
    if idx != set(range(len(idx))):
        raise KeyError(f"{prefix} indices are not 0..{len(idx) - 1}: {sorted(idx)[:8]}")
    return len(idx)


def layout_override(model_config, layout: Dict[str, Any]) -> Dict[str, Any]:
    """`layout` (what a checkpoint holds) after checking it against the
    same fields set in [model]: a disagreement raises KeyError."""
    for key, val in layout.items():
        if model_config.get(key) is not None and model_config[key] != val:
            raise KeyError(f"model.{key} = {model_config[key]!r} but the checkpoint holds {val!r}")
    return layout


def _resolve_count(count, config) -> int:
    return getattr(config, count) if isinstance(count, str) else int(count)


def _fused_names_sizes(entries):
    """entries: tuple of str (equal split) or (name, out_size) pairs."""
    if all(isinstance(e, str) for e in entries):
        return list(entries), None
    return [e[0] for e in entries], [int(e[1]) for e in entries]


def _split_rows(w: torch.Tensor, names, sizes):
    if sizes is None:
        return list(torch.chunk(w, len(names), dim=0))
    if sum(sizes) != w.shape[0]:
        raise ValueError(f"fused sizes {sizes} do not add up to {w.shape[0]} rows")
    return list(torch.split(w, sizes, dim=0))


def _stack_from_sd(sd, base: str, fmt: str, n: int) -> torch.Tensor:
    return torch.stack([sd[f"{base}{fmt.format(j)}.weight"].t() for j in range(n)]).contiguous()


def _stack_to_sd(sd, base: str, fmt: str, stacked: torch.Tensor):
    for j in range(stacked.shape[0]):
        sd[f"{base}{fmt.format(j)}.weight"] = stacked[j].t().contiguous()


def _linear_in(out, ours: str, sd, theirs: str):
    out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
    if f"{theirs}.bias" in sd:
        out[f"{ours}.bias"] = sd[f"{theirs}.bias"]


def _fused_in(out, ours_base: str, sd, theirs: str, entries):
    names, sizes = _fused_names_sizes(entries)
    ws = _split_rows(sd[f"{theirs}.weight"], names, sizes)
    bs = (_split_rows(sd[f"{theirs}.bias"], names, sizes)
          if f"{theirs}.bias" in sd else [None] * len(names))
    for name, w, b in zip(names, ws, bs):
        out[f"{ours_base}{_dotted(name)}.weight"] = w.contiguous()
        if b is not None:
            out[f"{ours_base}{_dotted(name)}.bias"] = b.contiguous()


def keymap_to_state_dict(sd: Mapping[str, torch.Tensor], km: KeyMap,
                         config) -> Dict[str, torch.Tensor]:
    """A torch-layout checkpoint -> the port's state dict (see module
    docstring): what interop.jax_to_state_dict makes of the JAX
    keymap_to_flax. A key the map needs and sd lacks, or a key of sd
    that it does not take (outside km.passthrough_patterns), raises
    KeyError naming them."""
    sd = TrackedDict(strip_known_prefixes(sd, km))
    out: Dict[str, torch.Tensor] = {}
    for ours, theirs in km.top_linears.items():
        _linear_in(out, _dotted(ours), sd, theirs)
    for ours, theirs in km.top_norms.items():
        out[f"{_dotted(ours)}.scale"] = sd[f"{theirs}.{km.top_norm_suffix}"]
    for ours, theirs in km.top_raw.items():
        out[_dotted(ours)] = sd[theirs]
    for ours, theirs in km.top_convs.items():
        _linear_in(out, _dotted(ours), sd, theirs)
    for ours, theirs in km.top_patch_linears.items():
        w = sd[f"{theirs}.weight"]  # [O, C, *k]
        perm = (0,) + tuple(range(2, w.dim())) + (1,)
        out[f"{_dotted(ours)}.weight"] = w.permute(perm).reshape(w.shape[0], -1).contiguous()
        if f"{theirs}.bias" in sd:
            out[f"{_dotted(ours)}.bias"] = sd[f"{theirs}.bias"]
    for theirs, entries in km.top_fused.items():
        _fused_in(out, "", sd, theirs, entries)
    for ours, (fmt, count) in km.top_stacks.items():
        out[_dotted(ours)] = _stack_from_sd(sd, "", fmt, _resolve_count(count, config))
    for bg in km.blocks:
        for i in range(_resolve_count(bg.num_layers_attr, config)):
            src, dst = f"{bg.prefix}.{bg.offset + i}.", f"{bg.flax_key}.{i}."
            for ours, (fmt, count) in bg.stacks.items():
                out[dst + _dotted(ours)] = _stack_from_sd(sd, src, fmt,
                                                          _resolve_count(count, config))
            for ours, theirs in bg.linears.items():
                _linear_in(out, dst + _dotted(ours), sd, src + theirs)
            for ours, theirs in bg.norms.items():
                out[f"{dst}{_dotted(ours)}.scale"] = sd[f"{src}{theirs}.{bg.norm_suffix}"]
            for ours, theirs in bg.raw.items():
                out[dst + _dotted(ours)] = sd[src + theirs]
            for theirs, entries in bg.fused.items():
                _fused_in(out, dst, sd, src + theirs, entries)
    sd.check_all_read(km.passthrough_patterns)
    return out


def _linear_out(sd, theirs: str, state_dict, ours: str):
    sd[f"{theirs}.weight"] = state_dict[f"{ours}.weight"]
    if f"{ours}.bias" in state_dict:
        sd[f"{theirs}.bias"] = state_dict[f"{ours}.bias"]


def _fused_out(sd, theirs: str, state_dict, ours_base: str, entries):
    names, _sizes = _fused_names_sizes(entries)
    keys = [f"{ours_base}{_dotted(n)}" for n in names]
    sd[f"{theirs}.weight"] = torch.cat([state_dict[f"{k}.weight"] for k in keys], dim=0)
    if all(f"{k}.bias" in state_dict for k in keys):
        sd[f"{theirs}.bias"] = torch.cat([state_dict[f"{k}.bias"] for k in keys], dim=0)


def keymap_from_state_dict(state_dict: Mapping[str, torch.Tensor], km: KeyMap,
                           config) -> Dict[str, torch.Tensor]:
    """The inverse of keymap_to_state_dict: the port's state dict -> a
    torch-layout checkpoint (the full fine-tuning export). Adapter factors
    and int8 scales are not part of it."""
    sd: Dict[str, torch.Tensor] = {}
    for ours, theirs in km.top_linears.items():
        _linear_out(sd, theirs, state_dict, _dotted(ours))
    for ours, theirs in km.top_norms.items():
        sd[f"{theirs}.{km.top_norm_suffix}"] = state_dict[f"{_dotted(ours)}.scale"]
    for ours, theirs in km.top_raw.items():
        sd[theirs] = state_dict[_dotted(ours)]
    for ours, theirs in km.top_convs.items():
        _linear_out(sd, theirs, state_dict, _dotted(ours))
    for ours, theirs in km.top_patch_linears.items():
        w = state_dict[f"{_dotted(ours)}.weight"]  # [O, prod(k) * C]
        c, *k = km.patch_linear_shapes[ours]
        w = w.reshape((w.shape[0], *k, c))
        perm = (0, len(k) + 1) + tuple(range(1, len(k) + 1))
        sd[f"{theirs}.weight"] = w.permute(perm).contiguous()
        if f"{_dotted(ours)}.bias" in state_dict:
            sd[f"{theirs}.bias"] = state_dict[f"{_dotted(ours)}.bias"]
    for theirs, entries in km.top_fused.items():
        _fused_out(sd, theirs, state_dict, "", entries)
    for ours, (fmt, _count) in km.top_stacks.items():
        _stack_to_sd(sd, "", fmt, state_dict[_dotted(ours)])
    for bg in km.blocks:
        for i in range(_resolve_count(bg.num_layers_attr, config)):
            src, dst = f"{bg.flax_key}.{i}.", f"{bg.prefix}.{bg.offset + i}."
            for ours, (fmt, _count) in bg.stacks.items():
                _stack_to_sd(sd, dst, fmt, state_dict[src + _dotted(ours)])
            for ours, theirs in bg.linears.items():
                _linear_out(sd, dst + theirs, state_dict, src + _dotted(ours))
            for ours, theirs in bg.norms.items():
                sd[f"{dst}{theirs}.{bg.norm_suffix}"] = state_dict[f"{src}{_dotted(ours)}.scale"]
            for ours, theirs in bg.raw.items():
                sd[dst + theirs] = state_dict[src + _dotted(ours)]
            for theirs, entries in bg.fused.items():
                _fused_out(sd, dst + theirs, state_dict, src, entries)
    return sd


# --- adapters -------------------------------------------------------------------

_LOKR_LEAVES = ("lokr_w1", "lokr_w2", "lokr_w2_a", "lokr_w2_b")


def _export(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().t().contiguous().cpu()


def _adapted_linears(km: KeyMap, config):
    """(our name, torch path, fused (names, sizes) or None) of every block
    linear and fused entry, block by block, then the top-level linears."""
    for bg in km.blocks:
        for i in range(_resolve_count(bg.num_layers_attr, config)):
            src, dst = f"{bg.flax_key}.{i}.", f"{bg.prefix}.{bg.offset + i}."
            for ours, theirs in bg.linears.items():
                yield src + _dotted(ours), dst + theirs, None
            for theirs, entries in bg.fused.items():
                yield src, dst + theirs, _fused_names_sizes(entries)
    for ours, theirs in km.top_linears.items():
        yield _dotted(ours), theirs, None


def export_lora_keymap(trainable: Mapping[str, torch.Tensor], km: KeyMap,
                       config) -> Dict[str, torch.Tensor]:
    """The adapter factors (port names) -> `<lora_prefix><torch path>.*`
    f32 tensors (see module docstring), in km.lora_renames' dialect."""
    out: Dict[str, torch.Tensor] = {}
    for ours, theirs, fused in _adapted_linears(km, config):
        dst = f"{km.lora_prefix}{theirs}"
        if fused is None:
            if f"{ours}.lora_a" in trainable:
                out[f"{dst}.lora_A.weight"] = _export(trainable[f"{ours}.lora_a"])
                out[f"{dst}.lora_B.weight"] = _export(trainable[f"{ours}.lora_b"])
            for leaf in _LOKR_LEAVES:
                if f"{ours}.{leaf}" in trainable:
                    out[f"{dst}.{leaf}"] = _export(trainable[f"{ours}.{leaf}"])
            continue
        keys = [ours + _dotted(n) for n in fused[0]]
        if all(f"{k}.lora_a" in trainable for k in keys):
            a = [_export(trainable[f"{k}.lora_a"]) for k in keys]   # [r, in] each
            b = [_export(trainable[f"{k}.lora_b"]) for k in keys]   # [out_j, r] each
            out[f"{dst}.lora_A.weight"] = torch.cat(a, dim=0)
            out[f"{dst}.lora_B.weight"] = torch.block_diag(*b)
        elif any(f"{k}.lora_a" in trainable for k in keys):
            raise ValueError(f"{theirs}: LoRA on only some parts of a fused weight")
        for j, k in enumerate(keys):
            for leaf in _LOKR_LEAVES:
                if f"{k}.{leaf}" in trainable:
                    out[f"{dst}.{j}.{leaf}"] = _export(trainable[f"{k}.{leaf}"])
    back = [(new, old) for old, new in km.lora_renames]
    return {_renamed(k, back): v for k, v in out.items()}


def save_lora_safetensors(path, sd: Mapping[str, torch.Tensor], alpha: Optional[float] = None,
                          rank: Optional[int] = None) -> None:
    """path/adapter_model.safetensors (metadata format = pt), with a `.alpha`
    entry for every LoRA pair when alpha is given: alpha for a pair of the
    trained rank, alpha * rows / rank for a fused pair of rows = n * rank,
    so alpha / rows stays the trained alpha / rank."""
    from pathlib import Path

    from .. import safetensors_io

    out = dict(sd)
    if alpha is not None:
        for k, a in sd.items():
            if k.endswith(".lora_A.weight"):
                rows = a.shape[0]
                value = alpha if rank is None or rows == rank else alpha * rows / rank
                out[k[: -len(".lora_A.weight")] + ".alpha"] = torch.tensor(value,
                                                                          dtype=torch.float32)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    safetensors_io.save_file(out, str(path / "adapter_model.safetensors"),
                             metadata={"format": "pt"})


def load_sd_for_pipeline(pipeline, path_keys=("ckpt_path", "transformer_path",
                                              "single_file_path", "diffusers_path")):
    """The checkpoint the model config names (the first of path_keys it
    sets; diffusers_path reads its `transformer/` folder when there is one),
    ComfyUI fp8 dequantized and model.merge_adapters fused in; the tensors
    of km.passthrough_patterns are kept on the pipeline as _passthrough_sd."""
    from pathlib import Path

    mc = pipeline.model_config
    path = None
    for key in path_keys:
        if mc.get(key):
            path = mc[key]
            if key == "diffusers_path":
                sub = Path(path) / "transformer"
                if sub.is_dir():
                    path = str(sub)
            break
    if path is None:
        raise FileNotFoundError(f"no checkpoint path in model config (looked for {path_keys})")
    sd = load_safetensors_dir(path)
    sd = dequantize_comfy_fp8(sd)
    sd = merge_adapters_into_state_dict(sd, mc.get("merge_adapters"))
    km = pipeline.keymap()
    if km is not None and km.passthrough_patterns:
        sd = strip_known_prefixes(sd, km)
        sd, keep = split_passthrough(sd, km)
        pipeline._passthrough_sd = keep
    return sd


def _split_fused_pair(key: str, a: torch.Tensor, b: torch.Tensor, sizes):
    """A fused pair (A [n r, in], B [sum(out), n r]) -> n (A_j, B_j), or a
    ValueError naming `key` when B is not block-diagonal with n rank
    blocks."""
    n = len(sizes)
    if a.shape[0] % n or b.shape[1] != a.shape[0] or b.shape[0] != sum(sizes):
        raise ValueError(f"{key}: a fused LoRA pair of shapes {tuple(a.shape)} / "
                         f"{tuple(b.shape)} does not split into {n} parts of {sizes} rows")
    r = a.shape[0] // n
    parts, row = [], 0
    for j, s in enumerate(sizes):
        block = b[row:row + s]
        off = torch.cat([block[:, :j * r], block[:, (j + 1) * r:]], dim=1)
        if bool(off.any()):
            raise ValueError(f"{key}: lora_B is not block-diagonal (part {j} has nonzero "
                             "entries outside its rank block)")
        parts.append((a[j * r:(j + 1) * r], block[:, j * r:(j + 1) * r]))
        row += s
    return parts


def import_lora_keymap(path, km: KeyMap, config) -> Dict[str, torch.Tensor]:
    """`adapter.init_from_existing`: the adapter factors (port names, [in, r]
    / [r, out], f32) of a saved adapter folder or file. Takes the prefixes
    of km.strip_prefixes and km.lora_prefix, and the lora_A/B and
    lora_down/up dialects and km.lora_renames'; fused pairs split back into
    their parts. A LoRA or LoKr tensor that matches no linear of the map is reported by name;
    none matching raises."""
    raw = load_safetensors_dir(path)
    prefixes = sorted(tuple(km.strip_prefixes) + (km.lora_prefix,), key=len, reverse=True)
    sd = {}
    for k, v in raw.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        k = _renamed(k, km.lora_renames)
        sd[k.replace(".lora_down.", ".lora_A.").replace(".lora_up.", ".lora_B.")] = v
    used = set()
    out: Dict[str, torch.Tensor] = {}

    def take(key):
        used.add(key)
        return sd[key].float().t().contiguous()

    for ours, theirs, fused in _adapted_linears(km, config):
        ka, kb = f"{theirs}.lora_A.weight", f"{theirs}.lora_B.weight"
        if fused is None:
            if ka in sd and kb in sd:
                out[f"{ours}.lora_a"], out[f"{ours}.lora_b"] = take(ka), take(kb)
            for leaf in _LOKR_LEAVES:
                if f"{theirs}.{leaf}" in sd:
                    out[f"{ours}.{leaf}"] = take(f"{theirs}.{leaf}")
            continue
        names, sizes = fused
        if ka in sd and kb in sd:
            a, b = sd[ka].float(), sd[kb].float()
            rows = sizes or [b.shape[0] // len(names)] * len(names)
            for name, (a_j, b_j) in zip(names, _split_fused_pair(theirs, a, b, rows)):
                out[f"{ours}{_dotted(name)}.lora_a"] = a_j.t().contiguous()
                out[f"{ours}{_dotted(name)}.lora_b"] = b_j.t().contiguous()
            used.update((ka, kb))
        for j, name in enumerate(names):
            for leaf in _LOKR_LEAVES:
                if f"{theirs}.{j}.{leaf}" in sd:
                    out[f"{ours}{_dotted(name)}.{leaf}"] = take(f"{theirs}.{j}.{leaf}")
    factors = [k for k in sd if k.endswith((".lora_A.weight", ".lora_B.weight", *_LOKR_LEAVES))]
    unmatched = [k for k in factors if k not in used]
    if not out:
        raise RuntimeError(f"init_from_existing: no adapter tensor in {path} matched this "
                           "model's keymap")
    if unmatched:
        print(f"WARNING: init_from_existing: {len(unmatched)} adapter tensors in {path} match "
              f"no adapted linear of this model and are not loaded: {unmatched[:5]}")
    pairs = sum(k.endswith(".lora_a") for k in out)
    print(f"init_from_existing: loaded {len(out)} adapter tensors ({pairs} LoRA pairs) "
          f"from {path}")
    return out
