"""GenericOptim, counterpart of diffusion_pipe_tpu/training/generic_optim.py:
a configurable momentum / second-moment / subspace optimizer, with
`adafactor` (factored second moment) and `adagrad` as aliases.

- momentum_type: "ema" | "none";
- second_moment_type: "ema" | "adagrad" | "sn" (subset norm: one moment a
  row of a tall matrix, a column of a wide one) | "factored" (Adafactor
  row / column) | "none";
- rank > 0: subspace momentum for matrices whose smaller side exceeds the
  rank. A projector P with orthonormal columns on the smaller side ("svd":
  its top singular vectors; "topk": the rows or columns of largest norm;
  "uniform": a random choice of them) is refreshed at step 1 and every
  update_proj_gap steps, which also resets the momentum; the momentum
  lives in the projected space and the update is P m plus the gradient's
  part outside P's span;
- bias correction, `+ weight_decay * p` on ndim > 1, `* -lr(step)`.

The math runs on each tensor as the JAX package lays it out (a Dense
kernel [in, out]). The JAX package's right-side projection (a tall
kernel) fails on its shapes (its _project_back contracts P's rank axis
with the rows); here it is proj P^T, the transpose of the wide case.
"uniform" draws its rows from torch's generator (seeded with 17 and the
step), not JAX's. SVD's singular vectors have arbitrary signs, and P P^T
does not depend on them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .optimizers import _UpdateRule, _lr_at, _weak


def _left(shape) -> Optional[bool]:
    """True: project the rows (m <= n), False: the columns, None: not 2-D."""
    if len(shape) < 2:
        return None
    return shape[-2] <= shape[-1]


def svd_projector(g: torch.Tensor, rank: int) -> torch.Tensor:
    """[..., m, n] -> P [..., side, rank], orthonormal columns: the top left
    singular vectors (m <= n) or right ones."""
    u, _, vh = torch.linalg.svd(g.float(), full_matrices=False)
    if _left(g.shape):
        return u[..., :, :rank]
    return vh[..., :rank, :].mT


def select_projector(g: torch.Tensor, rank: int, topk: bool, step: int) -> torch.Tensor:
    """One-hot P [..., side, rank] choosing `rank` rows (m <= n) or columns:
    those of largest norm (topk) or a uniform draw without replacement."""
    left = _left(g.shape)
    sq = g.float() ** 2
    norms = sq.sum(-1) if left else sq.sum(-2)      # [..., side]
    dim = norms.shape[-1]
    if topk:
        idx = torch.topk(norms, rank, dim=-1).indices
    else:
        gen = torch.Generator().manual_seed(17 * 1000003 + int(step))
        flat = norms.reshape(-1, dim)
        idx = torch.stack([torch.randperm(dim, generator=gen)[:rank] for _ in flat])
        idx = idx.reshape(norms.shape[:-1] + (rank,)).to(g.device)
    return torch.nn.functional.one_hot(idx, dim).float().mT


def project(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """P^T G (left) or G P (right)."""
    return p.mT @ g if _left(g.shape) else g @ p


def project_back(p: torch.Tensor, proj: torch.Tensor, left: bool) -> torch.Tensor:
    """P proj (left) or proj P^T (right)."""
    return p @ proj if left else proj @ p.mT


class GenericOptim(_UpdateRule):
    jax_layout_math = True  # the factored moment's and projection's sides

    def __init__(self, params, lr=1e-4, momentum_type: str = "ema",
                 second_moment_type: str = "ema", betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, correct_bias: bool = True, rank: int = 0,
                 proj_type: str = "svd", update_proj_gap: int = 200,
                 weight_decay: float = 0.0, **kw):
        if proj_type not in ("svd", "topk", "uniform"):
            raise ValueError(f"proj_type {proj_type!r}: expected svd, topk or uniform")
        super().__init__(params, dict(lr=lr, momentum_type=momentum_type,
                                      second_moment_type=second_moment_type,
                                      betas=tuple(betas), eps=eps, correct_bias=correct_bias,
                                      rank=rank, proj_type=proj_type,
                                      update_proj_gap=update_proj_gap,
                                      weight_decay=weight_decay), **kw)

    def _update(self, p, g, st, group):
        b1, b2 = group["betas"]
        eps, rank = group["eps"], group["rank"]
        second = group["second_moment_type"]
        g32 = g.float()
        left = _left(g.shape)
        projectable = rank > 0 and g.dim() >= 2 and min(g.shape[-2:]) > rank
        if not st:
            st["step"] = 0
            if group["momentum_type"] != "none":
                if projectable:
                    shape = (g.shape[:-2] + (rank, g.shape[-1]) if left
                             else g.shape[:-2] + (g.shape[-2], rank))
                    st["m"] = torch.zeros(shape, device=g.device)
                else:
                    st["m"] = torch.zeros_like(g32)
            if second == "sn" and g.dim() >= 2:
                st["v"] = torch.zeros(g.shape[:-1] + (1,) if g.shape[-2] >= g.shape[-1]
                                      else g.shape[:-2] + (1, g.shape[-1]), device=g.device)
            elif second == "factored" and g.dim() >= 2:
                st["vr"] = torch.zeros(g.shape[:-1], device=g.device)
                st["vc"] = torch.zeros(g.shape[:-2] + g.shape[-1:], device=g.device)
            elif second != "none":
                st["v"] = torch.zeros_like(g32)
        lr = _lr_at(group["lr"], st["step"] - st.get("schedule_offset", 0))
        st["step"] += 1
        step = st["step"]
        m = st.get("m")

        if projectable:
            if step == 1 or step % group["update_proj_gap"] == 0:
                st["proj"] = (svd_projector(g32, rank) if group["proj_type"] == "svd"
                              else select_projector(g32, rank, group["proj_type"] == "topk",
                                                    step))
                if m is not None and step > 1:
                    m = torch.zeros_like(m)
            pmat = st["proj"]
            proj_g = project(pmat, g32)
        else:
            pmat, proj_g = None, g32

        if m is not None:
            m = b1 * m + (1.0 - b1) * proj_g
            st["m"] = m
            if pmat is not None:
                numerator = project_back(pmat, m, left) + (g32 - project_back(pmat, proj_g, left))
            else:
                numerator = m
        else:
            numerator = g32

        has_v = "v" in st or "vr" in st
        if not has_v:
            denom = 1.0
        elif second == "sn" and g.dim() >= 2:
            axis = -1 if g.shape[-2] >= g.shape[-1] else -2
            st["v"] = b2 * st["v"] + (1.0 - b2) * torch.sum(g32 * g32, dim=axis, keepdim=True)
            denom = torch.sqrt(st["v"]) + eps
        elif second == "factored" and g.dim() >= 2:
            st["vr"] = b2 * st["vr"] + (1.0 - b2) * torch.mean(g32 * g32, dim=-1)
            st["vc"] = b2 * st["vc"] + (1.0 - b2) * torch.mean(g32 * g32, dim=-2)
            r = st["vr"] / torch.clamp(torch.mean(st["vr"], dim=-1, keepdim=True), min=1e-30)
            denom = torch.sqrt(r[..., None] * st["vc"][..., None, :]) + eps
        elif second == "adagrad":
            st["v"] = st["v"] + g32 * g32
            denom = torch.sqrt(st["v"]) + eps
        elif second == "ema":
            st["v"] = b2 * st["v"] + (1.0 - b2) * g32 * g32
            denom = torch.sqrt(st["v"]) + eps
        else:  # "sn" or "factored" on a vector: its moment stays unused
            denom = 1.0

        if group["correct_bias"]:
            if m is not None:
                numerator = numerator / float(np.float32(1) - np.float32(b1) ** np.float32(step))
            if has_v and second == "ema":
                bc2 = np.float32(1) - np.float32(b2) ** np.float32(step)
                denom = denom / float(np.sqrt(bc2))

        update = (numerator / denom).to(g.dtype)
        if group["weight_decay"] and p.dim() > 1:
            update = update + _weak(group["weight_decay"], p) * p
        return _weak(-lr, update) * update
