"""The Qwen2.5-VL vision tower (ViT) as a PyTorch module, for Qwen-Image-Edit's
control image.

Counterpart of diffusion_pipe_tpu/models/vision_encoders.py, itself
transformers' Qwen2_5_VisionTransformerPretrainedModel with static shapes
(one grid per image size):

  - the patch embedding, a bias-free Conv3d of temporal 2 x 14 x 14
    patches, as one linear over the flattened patch;
  - 2-D rotary embedding from the spatial-merge-blocked (h, w) ids;
  - windowed attention: the tokens reordered so that each window is
    contiguous (merge-unit granularity, computed in numpy), block-diagonal
    masks from the window boundaries, full attention in the designated
    layers;
  - RMS norm and SwiGLU MLP blocks, qkv with bias;
  - the 2 x 2 patch merger (RMS norm, MLP) to out_hidden_size, back in the
    original order.

The block-diagonal attention is plain torch (f32 logits and softmax), as the
JAX module computes it outside any Pallas kernel. Parameter names follow the
JAX module with `block_{i}` as `blocks.{i}` (interop.tree_to_state_dict).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_NEG = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    out_hidden_size: int = 3584
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @staticmethod
    def from_hf_config(cfg: dict, dtype=torch.float32) -> "QwenVLVisionConfig":
        v = cfg.get("vision_config", cfg)
        return QwenVLVisionConfig(
            depth=v["depth"], hidden_size=v["hidden_size"],
            intermediate_size=v["intermediate_size"], num_heads=v["num_heads"],
            patch_size=v.get("patch_size", 14),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            window_size=v.get("window_size", 112),
            out_hidden_size=v.get("out_hidden_size", 3584),
            fullatt_block_indexes=tuple(v.get("fullatt_block_indexes", (7, 15, 23, 31))),
            dtype=dtype, param_dtype=dtype)


def rot_pos_ids(grid_thw, merge: int) -> np.ndarray:
    """Per-token (h, w) position ids in the spatial-merge-blocked order
    (transformers' rot_pos_emb). [seq, 2]."""
    out = []
    for t, h, w in grid_thw:
        hp = np.tile(np.arange(h)[:, None], (1, w))
        hp = hp.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        wp = np.tile(np.arange(w)[None, :], (h, 1))
        wp = wp.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        out.append(np.tile(np.stack([hp, wp], axis=-1), (t, 1)))
    return np.concatenate(out, axis=0)


def window_index(grid_thw, window_size: int, merge: int, patch: int):
    """(window_index [n_merged], cu_window_seqlens): transformers'
    get_window_index in numpy."""
    idx_list, cu, base = [], [0], 0
    vit_win = window_size // merge // patch
    unit = merge * merge
    for t, h, w in grid_thw:
        lh, lw = h // merge, w // merge
        index = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % vit_win, (-lw) % vit_win
        nwh, nww = (lh + pad_h) // vit_win, (lw + pad_w) // vit_win
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
        padded[:, :lh, :lw] = index
        padded = padded.reshape(t, nwh, vit_win, nww, vit_win).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nwh * nww, vit_win, vit_win)
        seqlens = (padded != -100).sum((2, 3)).reshape(-1) * unit
        flat = padded.reshape(-1)
        idx_list.append(flat[flat != -100] + base)
        cu.extend((np.cumsum(seqlens) + cu[-1]).tolist())
        base += t * lh * lw
    cu = [c for i, c in enumerate(cu) if i == 0 or c != cu[i - 1]]
    return np.concatenate(idx_list), np.asarray(cu, np.int64)


def _block_diag_mask(cu: np.ndarray, seq: int) -> np.ndarray:
    """[seq, seq] bool, True where query and key share a cu segment."""
    seg = np.zeros((seq,), np.int64)
    for i in range(len(cu) - 1):
        seg[cu[i]:cu[i + 1]] = i
    return seg[:, None] == seg[None, :]


def _rms(y: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    yf = y.float()
    yf = yf * torch.rsqrt(yf.pow(2).mean(-1, keepdim=True) + eps)
    return (yf * scale.float()).to(y.dtype)


def _linear(cfg: QwenVLVisionConfig, i: int, o: int, bias: bool = True) -> nn.Linear:
    return nn.Linear(i, o, bias=bias, dtype=cfg.param_dtype)


class QwenVLVisionBlock(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        self.cfg = cfg
        d, pd = cfg.hidden_size, cfg.param_dtype
        self.norm1 = nn.Parameter(torch.empty(d, dtype=pd))
        self.norm2 = nn.Parameter(torch.empty(d, dtype=pd))
        self.qkv = _linear(cfg, d, 3 * d)
        self.proj = _linear(cfg, d, d)
        self.mlp_gate = _linear(cfg, d, cfg.intermediate_size)
        self.mlp_up = _linear(cfg, d, cfg.intermediate_size)
        self.mlp_down = _linear(cfg, cfg.intermediate_size, d)

    def _dense(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))

    def forward(self, x, cos, sin, mask):
        """x [seq, hidden] in cfg.dtype; cos / sin [seq, head_dim] f32; mask
        [seq, seq] bool."""
        cfg = self.cfg
        h, d = cfg.num_heads, cfg.head_dim
        s = x.shape[0]
        q, k, v = (u.reshape(s, h, d)
                   for u in self._dense(self.qkv, _rms(x, self.norm1, cfg.rms_eps)).chunk(3, -1))

        def rope(y):
            yf = y.float()
            y1, y2 = yf.chunk(2, dim=-1)
            return (yf * cos[:, None] + torch.cat([-y2, y1], -1) * sin[:, None]).to(y.dtype)

        q, k = rope(q), rope(k)
        logits = torch.einsum("qhd,khd->hqk", q.float(), k.float()) / np.sqrt(d)
        attn = torch.softmax(logits.masked_fill(~mask[None], _NEG), -1).to(v.dtype)
        o = torch.einsum("hqk,khd->qhd", attn, v).reshape(s, h * d)
        x = x + self._dense(self.proj, o)
        y = _rms(x, self.norm2, cfg.rms_eps)
        gate = F.silu(self._dense(self.mlp_gate, y))
        return x + self._dense(self.mlp_down, gate * self._dense(self.mlp_up, y))


class QwenVLVisionTower(nn.Module):
    """pixels [seq, C * tp * ps * ps] flattened patches of the images of
    grid_thw ((t, h, w) each) -> [seq / merge^2, out_hidden_size]."""

    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        self.cfg = cfg
        d, unit = cfg.hidden_size, cfg.spatial_merge_size ** 2
        self.patch_embed = _linear(cfg, cfg.patch_dim, d, bias=False)
        self.blocks = nn.ModuleList([QwenVLVisionBlock(cfg) for _ in range(cfg.depth)])
        self.merger_ln_q = nn.Parameter(torch.empty(d, dtype=cfg.param_dtype))
        self.merger_fc1 = _linear(cfg, unit * d, unit * d)
        self.merger_fc2 = _linear(cfg, unit * d, cfg.out_hidden_size)
        self._tables = {}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded weights: linears normal of variance 1/fan_in, biases zero,
        norm scales one; drawn in f32, then cast."""
        for name, p in self.named_parameters():
            if p.dim() == 2:
                tmp = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                                  device=p.device)
                p.copy_(tmp.mul_(p.shape[1] ** -0.5))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)

    def tables(self, grid_thw: Tuple[Tuple[int, int, int], ...], seq: int, device):
        """The static tables of a grid on `device`: token order, the inverse
        window order, RoPE cos / sin in token order, full and window masks."""
        key = (tuple(map(tuple, grid_thw)), str(device))
        if key not in self._tables:
            cfg = self.cfg
            merge = cfg.spatial_merge_size
            unit = merge * merge
            pos = rot_pos_ids(grid_thw, merge)
            half = cfg.head_dim // 2
            inv = 1.0 / (10000.0 ** (np.arange(0, half, 2, np.float32) / half))
            freqs = np.concatenate([pos[:, 0:1] * inv[None], pos[:, 1:2] * inv[None]], -1)
            emb = np.concatenate([freqs, freqs], -1)
            widx, cu_win = window_index(grid_thw, cfg.window_size, merge, cfg.patch_size)
            order = (widx[:, None] * unit + np.arange(unit)[None]).reshape(-1)
            cu_full = np.concatenate([[0], np.cumsum([t * h * w for t, h, w in grid_thw])])

            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

            self._tables[key] = dict(
                order=dev(order), restore=dev(np.argsort(widx)),
                cos=dev(np.cos(emb)[order].astype(np.float32)),
                sin=dev(np.sin(emb)[order].astype(np.float32)),
                full=dev(_block_diag_mask(cu_full, seq)), win=dev(_block_diag_mask(cu_win, seq)))
        return self._tables[key]

    def forward(self, pixels: torch.Tensor, grid_thw) -> torch.Tensor:
        cfg = self.cfg
        unit = cfg.spatial_merge_size ** 2
        seq = pixels.shape[0]
        tb = self.tables(grid_thw, seq, pixels.device)
        x = pixels.reshape(seq, cfg.patch_dim).to(cfg.dtype)
        x = F.linear(x, self.patch_embed.weight.to(cfg.dtype))[tb["order"]]
        for i, blk in enumerate(self.blocks):
            mask = tb["full"] if i in cfg.fullatt_block_indexes else tb["win"]
            x = blk(x, tb["cos"], tb["sin"], mask)
        x = _rms(x, self.merger_ln_q, cfg.rms_eps).reshape(seq // unit, unit * cfg.hidden_size)
        fc1, fc2 = self.merger_fc1, self.merger_fc2
        x = F.gelu(F.linear(x, fc1.weight.to(x.dtype), fc1.bias.to(x.dtype)))
        x = F.linear(x, fc2.weight.to(x.dtype), fc2.bias.to(x.dtype))
        return x[tb["restore"]]


def convert_hf_qwen_vision(sd: Mapping[str, torch.Tensor], cfg: QwenVLVisionConfig,
                           prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """transformers' Qwen2.5-VL vision state dict -> the port's tower state
    dict (the Conv3d patch weight flattened to [hidden, C * t * h * w]).
    Raises KeyError naming the missing keys."""
    want = {"merger_ln_q": "merger.ln_q.weight"}
    for ours, theirs in (("merger_fc1", "merger.mlp.0"), ("merger_fc2", "merger.mlp.2")):
        want[f"{ours}.weight"], want[f"{ours}.bias"] = theirs + ".weight", theirs + ".bias"
    names = {"qkv": "attn.qkv", "proj": "attn.proj", "mlp_gate": "mlp.gate_proj",
             "mlp_up": "mlp.up_proj", "mlp_down": "mlp.down_proj"}
    for i in range(cfg.depth):
        want[f"blocks.{i}.norm1"] = f"blocks.{i}.norm1.weight"
        want[f"blocks.{i}.norm2"] = f"blocks.{i}.norm2.weight"
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                want[f"blocks.{i}.{ours}.{leaf}"] = f"blocks.{i}.{theirs}.{leaf}"
    patch = prefix + "patch_embed.proj.weight"
    missing = [prefix + k for k in want.values() if prefix + k not in sd]
    missing += [] if patch in sd else [patch]
    if missing:
        raise KeyError(f"vision checkpoint lacks {len(missing)} keys, e.g. {missing[:5]}")
    out = {ours: sd[prefix + theirs] for ours, theirs in want.items()}
    out["patch_embed.weight"] = sd[patch].reshape(cfg.hidden_size, -1)
    return out


def qwen_vl_rope_index(ids: np.ndarray, image_token_id: int, grid_thw, merge: int) -> np.ndarray:
    """Multimodal (t, h, w) position ids [3, S] for one image in the
    sequence (transformers' get_rope_index, the one-image static case):
    text before the image sequential, the image block at its start plus
    (t, row, col), the text after it from start + max(t, h, w) on."""
    s = ids.shape[0]
    pos = np.zeros((3, s), np.int64)
    img_positions = np.nonzero(ids == image_token_id)[0]
    if img_positions.size == 0:
        pos[:] = np.arange(s)
        return pos
    t, h, w = grid_thw
    lh, lw = h // merge, w // merge
    st = int(img_positions[0])
    n_img = t * lh * lw
    pos[:, :st] = np.arange(st)
    pos[0, st:st + n_img] = st + np.repeat(np.arange(t), lh * lw)
    pos[1, st:st + n_img] = st + np.tile(np.repeat(np.arange(lh), lw), t)
    pos[2, st:st + n_img] = st + np.tile(np.arange(lw), t * lh)
    pos[:, st + n_img:] = st + max(t, lh, lw) + np.arange(s - (st + n_img))
    return pos


def image_to_qwen_patches(img: np.ndarray, patch: int = 14, temporal_patch: int = 2,
                          merge: int = 2) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """RGB [C, H, W] in [-1, 1] -> (flattened patches [gh * gw, C * tp * ps *
    ps] in transformers' Qwen2-VL order with CLIP's normalization, grid (1,
    gh, gw)). H and W are multiples of patch * merge."""
    mean = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
    x = (img.astype(np.float32) + 1.0) / 2.0
    x = (x - mean[:, None, None]) / std[:, None, None]
    c, hh, ww = x.shape
    gh, gw = hh // patch, ww // patch
    frames = np.tile(x[None], (temporal_patch, 1, 1, 1))
    p = frames.reshape(1, temporal_patch, c, gh // merge, merge, patch, gw // merge, merge, patch)
    p = p.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return p.reshape(gh * gw, c * temporal_patch * patch * patch), (1, gh, gw)
