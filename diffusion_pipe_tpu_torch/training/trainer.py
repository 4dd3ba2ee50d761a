"""Train step and train-state builders, counterpart of
diffusion_pipe_tpu/training/trainer.py.

One step: noising -> forward -> masked loss -> backward (trainable
parameters only) -> global-norm clip -> optimizer update. The global norm
and the clip scale follow optax.global_norm's dtypes (bf16 for bf16
gradients). With gradient accumulation the batch is split into microbatches
whose f32 gradients are averaged (the mean-over-microbatches semantics of
the JAX package) and stay f32 through the clip into the optimizer, as in
the JAX package, whatever the parameter dtype. With stochastic rounding,
bf16 parameters are updated through K4 (ops/quant.py). With
gradient_release the optimizer steps once a micro-batch instead, and no
accumulator exists. The adapters' dropout draws its masks inside the step
only (models/layers.py adapter_dropout).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..interop import load_state_dict
from ..models.layers import KeepMasks, adapter_dropout, prequantize_int8_
from .train_state import TrainState, partition_params


def init_train_state(pipeline, optimizer: Callable, generator: torch.Generator,
                     predicate: Callable,
                     state_dict: Optional[Dict[str, torch.Tensor]] = None,
                     partial: bool = False) -> TrainState:
    """Initialise the pipeline's weights (then load `state_dict` over them
    when given, int8 weights included; with `partial`, the entries it lacks
    keep their initialisation, as the JAX complete_params fills the leaves a
    converted checkpoint lacks), split trainable from frozen,
    pre-quantize the frozen int8_matmul weights once (as the JAX
    init_train_state does), and build the optimizer from the factory that
    get_optimizer returned."""
    pipeline.init_params(generator)
    if state_dict is not None:
        load_state_dict(pipeline.model, state_dict, partial=partial)
    trainable = partition_params(pipeline.model, predicate)
    prequantize_int8_(pipeline.model)
    return TrainState(step=0, examples=0, trainable=trainable,
                      optimizer=optimizer(list(trainable.values()), names=list(trainable)))


def make_loss_fn(pipeline, timestep_quantile=None):
    def loss_fn(batch, generator=None, noise=None, t=None):
        model_inputs, target, mask = pipeline.prepare_inputs(
            batch, generator, timestep_quantile=timestep_quantile, noise=noise, t=t)
        return pipeline.loss_fn(pipeline.forward(model_inputs), target, mask)

    return loss_fn


def make_eval_step(pipeline):
    """eval_step(batch, generator, quantile) -> f32 loss, without gradients:
    t at the fixed quantile of the timestep distribution, the noise from
    the generator."""

    @torch.no_grad()
    def eval_step(batch, generator, timestep_quantile):
        return make_loss_fn(pipeline, timestep_quantile)(batch, generator)

    return eval_step


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm, dtype for dtype: each leaf squared in its own
    dtype, summed in f32 and the sum rounded back to the leaf's dtype; the
    leaf sums added in the promoted dtype from a zero of the first leaf's
    dtype; the square root in that dtype. bf16 gradients give a bf16 norm,
    f32 gradients the plain f32 one."""
    total = None
    for g in grads:
        s = torch.sum(g * g, dtype=torch.float32).to(g.dtype)
        total = s if total is None else total + s
    return torch.sqrt(total) if total is not None else torch.zeros([])


def clip_by_global_norm(grads, grad_norm: torch.Tensor, clipping: float):
    """Each gradient times min(1, clipping / (norm + 1e-6)), the scale in the
    norm's dtype and the product rounded to the gradient's dtype, as the JAX
    trainer computes it."""
    scale = torch.clamp(clipping / (grad_norm + 1e-6), max=1.0)
    return [(g.float() * scale.float()).to(g.dtype) for g in grads]


def _slice(x, sl):
    return None if x is None else x[sl]


def dropout_masks(state: TrainState, generator=None) -> KeepMasks:
    """A step's adapter-dropout masks: seeded with the generator's seed and
    the step count, so a resumed run draws what an uninterrupted one does,
    with no read from the card."""
    base = generator.initial_seed() if generator is not None else 0
    return KeepMasks((base * 1000003 + state.step) % (2**63))


def make_train_step(pipeline, gradient_clipping: float = 1.0,
                    gradient_accumulation_steps: int = 1,
                    skip_invalid_grads: bool = False,
                    stochastic_rounding: bool = False,
                    gradient_release: bool = False):
    """Returns train_step(state, batch, generator=None, noise=None, t=None)
    -> metrics, updating `state` and the model in place.

    batch leaves are [GAS * mbs, ...]; noise [B, C, H, W] and t [B], when
    given, replace the generator's draws and are split with the batch. The
    adapters' keep masks are dropout_masks(state, generator).

    skip_invalid_grads: a parameter whose gradient holds Inf/NaN keeps its
    value this step (its update is masked in optimizers.apply_update, as
    the JAX step masks it), and its gradient counts as zero in the global
    norm and in its optimizer state's update.

    stochastic_rounding: a bf16 parameter becomes SR(f32(p) + f32(u)),
    seeded with state.step (the count before this step) * 1000003 + its
    index among the trainable tensors (see _UpdateRule.step in
    optimizers.py); other dtypes take p + u.

    gradient_release (with GAS > 1): the JAX gradient_release_step. Each
    micro-batch's gradients, in the parameters' dtype, are masked (skip
    invalid), clipped on their own global norm and applied at once, every
    micro-batch's update seeded with the same state.step; the loss and the
    norm reported are the micro-batches' means.
    """
    loss_fn = make_loss_fn(pipeline)
    gas = gradient_accumulation_steps

    def grads_of(params):
        return [torch.zeros_like(p) if p.grad is None else p.grad for p in params]

    def update(state, params, grads, metrics):
        """Mask, norm, clip and apply; returns the global norm."""
        finite = None
        if skip_invalid_grads:
            finite = [torch.isfinite(g).all() for g in grads]
            grads = [torch.where(ok, g, torch.zeros_like(g)) for g, ok in zip(grads, finite)]
            skipped = sum((~ok).int() for ok in finite)
            metrics["skipped_params"] = metrics.get("skipped_params", 0) + skipped
        grad_norm = global_norm(grads)
        if gradient_clipping and gradient_clipping > 0:
            grads = clip_by_global_norm(grads, grad_norm, gradient_clipping)
        step_kw = dict(grads=grads, sr_step=state.step if stochastic_rounding else None)
        if finite is not None:
            step_kw["finite"] = finite
        state.optimizer.step(**step_kw)
        state.optimizer.zero_grad(set_to_none=True)
        return grad_norm

    def train_step(state: TrainState, batch: Dict[str, Any], generator=None,
                   noise=None, t=None):
        params = list(state.trainable.values())
        state.optimizer.zero_grad(set_to_none=True)
        batch_size = batch["latents"].shape[0]
        masks = dropout_masks(state, generator)
        metrics: Dict[str, Any] = {}
        if gas == 1:
            with adapter_dropout(masks):
                loss = loss_fn(batch, generator, noise, t)
            loss.backward()
            metrics["loss"] = loss.detach()
            metrics["grad_norm"] = update(state, params, grads_of(params), metrics)
        else:
            mbs = batch_size // gas
            acc = None if gradient_release else [
                torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = torch.zeros([], dtype=torch.float32, device=pipeline.device)
            norm = torch.zeros([], dtype=torch.float32, device=pipeline.device)
            for i in range(gas):
                sl = slice(i * mbs, (i + 1) * mbs)
                sub = {k: _slice(v, sl) for k, v in batch.items()}
                with adapter_dropout(masks):
                    loss_i = loss_fn(sub, generator, _slice(noise, sl), _slice(t, sl))
                loss_i.backward()
                loss += loss_i.detach()
                if gradient_release:
                    norm = norm + update(state, params, grads_of(params), metrics)
                    continue
                for a, p in zip(acc, params):
                    if p.grad is not None:
                        a.add_(p.grad.float())
                        p.grad = None
            metrics["loss"] = loss / gas
            if gradient_release:
                metrics["grad_norm"] = norm / gas
            else:
                metrics["grad_norm"] = update(state, params, [a / gas for a in acc], metrics)
        state.step += 1
        state.examples += batch_size
        return metrics

    return train_step
