"""Muon, counterpart of diffusion_pipe_tpu/training/muon.py, which the JAX
package also runs for `adamuon` and `normuon`: momentum orthogonalized by
Newton-Schulz iterations in bf16 for every parameter whose last two axes
both exceed 1 (its leading axes batched), scaled by sqrt(max(1, rows /
cols)) of the JAX kernel's layout; AdamW for the rest. Weight decay on
every parameter; the schedule read at the count after this step, as the
JAX transform reads it. The Newton-Schulz products are plain torch.matmul:
they are XLA dots in the JAX package, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import weak_scalar
from .optimizers import _UpdateRule, _lr_at

NS_STEPS = 5
NS_COEFFS = (3.4445, -4.7750, 2.0315)
POLAR_EXPRESS_COEFFS = (
    (8.156554524902461, -22.48329292557795, 15.878769915207462),
    (4.042929935166739, -2.808917465908714, 0.5000178451051316),
    (3.8916678022926607, -2.772484153217685, 0.5060648178503393),
    (3.285753657755655, -2.3681294933425376, 0.46449024233003106),
    (2.3465413258596377, -1.7097828382687081, 0.42323551169305323),
)


def newton_schulz_orthogonalize(g: torch.Tensor, steps: int = NS_STEPS,
                                polar_express: bool = False) -> torch.Tensor:
    """The trailing 2-D of g (>= 2-D) orthogonalized, f32 out: bf16
    iterations on the wide orientation (a tall matrix is transposed first
    and back after), x / ||x||_F then x <- a x + (b A + c A A) x with A =
    x x^T; Polar Express: its five (a, b, c) and x / (1.02 ||x|| + 1e-6)."""
    x = g.to(torch.bfloat16)
    transposed = x.shape[-2] > x.shape[-1]
    if transposed:
        x = x.mT

    def norm(v):
        return torch.sqrt(torch.sum(v.float() ** 2, dim=(-2, -1), keepdim=True)).to(v.dtype)

    if polar_express:
        x = x / (norm(x) * weak_scalar(1 + 2e-2, x) + weak_scalar(1e-6, x))
        coeffs = POLAR_EXPRESS_COEFFS
    else:
        x = x / (norm(x) + weak_scalar(1e-7, x))
        coeffs = (NS_COEFFS,) * steps
    for a, b, c in coeffs:
        A = x @ x.mT
        B = weak_scalar(b, A) * A + weak_scalar(c, A) * (A @ A)
        x = weak_scalar(a, x) * x + B @ x
    if transposed:
        x = x.mT
    return x.float()


class Muon(_UpdateRule):
    jax_layout_math = True  # rows / cols of the JAX kernel

    def __init__(self, params, lr=1e-4, momentum: float = 0.95, nesterov: bool = True,
                 weight_decay: float = 0.0, adam_b1: float = 0.9, adam_b2: float = 0.999,
                 adam_eps: float = 1e-8, polar_express: bool = False, **kw):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov,
                                      weight_decay=weight_decay, adam_b1=adam_b1,
                                      adam_b2=adam_b2, adam_eps=adam_eps,
                                      polar_express=polar_express), **kw)

    def _update(self, p, g, st, group):
        g = g.float()
        if not st:
            st.update(step=0, momentum=torch.zeros_like(g))
            if not _is_matrix(g):
                st.update(mu=torch.zeros_like(g), nu=torch.zeros_like(g))
        st["step"] += 1
        count = st["step"]
        if _is_matrix(g):
            mom = group["momentum"] * st["momentum"] + g
            st["momentum"] = mom
            use = g + group["momentum"] * mom if group["nesterov"] else mom
            o = newton_schulz_orthogonalize(use, polar_express=group["polar_express"])
            step = o * float(np.sqrt(np.float32(max(1.0, g.shape[-2] / g.shape[-1]))))
        else:
            b1, b2 = group["adam_b1"], group["adam_b2"]
            st["mu"] = b1 * st["mu"] + (1 - b1) * g
            st["nu"] = b2 * st["nu"] + (1 - b2) * g * g
            cf = np.float32(count)
            mhat = st["mu"] / float(np.float32(1) - np.float32(b1) ** cf)
            nhat = st["nu"] / float(np.float32(1) - np.float32(b2) ** cf)
            step = mhat / (torch.sqrt(nhat) + group["adam_eps"])
        if group["weight_decay"]:
            step = step + group["weight_decay"] * p.float()
        lr = _lr_at(group["lr"], count - st.get("schedule_offset", 0))
        return -lr * step


def _is_matrix(g: torch.Tensor) -> bool:
    return g.dim() >= 2 and g.shape[-1] > 1 and g.shape[-2] > 1
