"""DatasetManager (the caching phase) and PipelineDataLoader (the train
iterator).

The port's copy of diffusion_pipe_tpu/data/loader.py, with the same
observable behaviour: infinite iteration, epoch tracking, an
{epoch, num_batches_pulled} state for exact resume, and the substitution of
unconditional embeddings for CFG-dropout training (uncond_fraction). One
difference that changes no result: the pipeline's encoder functions build
the VAE and the text encoders at their first call, so a run whose cache is
complete never builds them.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from .dataset import Dataset


class DatasetManager:
    """Runs the caching phase for registered datasets."""

    def __init__(self, model_pipeline, regenerate_cache: bool = False,
                 trust_cache: bool = False, caching_batch_size: int = 1):
        self.pipeline = model_pipeline
        self.regenerate_cache = regenerate_cache
        self.trust_cache = trust_cache
        self.caching_batch_size = caching_batch_size
        self.datasets: List[Dataset] = []

    def register(self, dataset: Dataset):
        self.datasets.append(dataset)

    def cache(self):
        vae_fn = self.pipeline.get_call_vae_fn()
        te_fns = self.pipeline.get_call_text_encoder_fns()
        for ds in self.datasets:
            ds.scan(regenerate=self.regenerate_cache,
                    trust_cache=self.trust_cache)
            for bucket_ds in ds.all_size_bucket_datasets():
                bucket_ds.cache_latents(
                    vae_fn, regenerate=self.regenerate_cache,
                    caching_batch_size=self.caching_batch_size,
                )
                for i, te_fn in enumerate(te_fns):
                    bucket_ds.cache_text_embeddings(
                        te_fn, i, regenerate=self.regenerate_cache,
                        caching_batch_size=self.caching_batch_size,
                    )
                if ds.uncond_fraction > 0:
                    uncond = {}
                    for te_fn in te_fns:
                        out = te_fn([""])
                        uncond.update({k: v[0] for k, v in out.items()})
                    bucket_ds.set_uncond_embeddings(uncond)


class PipelineDataLoader:
    """Infinite epoch-tracking batch iterator.

    Yields (size_bucket, batch dict) where batch leaves are CPU tensors of
    shape [gas * mbs, ...]; the train step does the microbatch split.
    Resume replays by skipping num_batches_pulled batches of the current
    epoch.
    """

    def __init__(self, dataset: Dataset, gradient_accumulation_steps: int = 1):
        self.dataset = dataset
        self.gas = gradient_accumulation_steps
        self.epoch = 1
        self.num_batches_pulled = 0
        self._iter: Optional[Iterator] = None
        self._rng = random.Random(0)

    def reset(self):
        self.epoch = 1
        self.num_batches_pulled = 0
        self._iter = None

    def state_dict(self) -> Dict[str, int]:
        return {
            "epoch": self.epoch,
            "num_batches_pulled": self.num_batches_pulled,
        }

    def load_state_dict(self, sd: Dict[str, int]):
        self.epoch = int(sd["epoch"])
        self.num_batches_pulled = int(sd["num_batches_pulled"])
        self._iter = self.dataset.iter_epoch(self.epoch)
        for _ in range(self.num_batches_pulled):
            next(self._iter, None)

    def __iter__(self):
        return self

    def _maybe_apply_uncond(self, batch: Dict[str, torch.Tensor]):
        frac = self.dataset.uncond_fraction
        if frac <= 0:
            return batch
        # substitute cached unconditional embeddings for a fraction of
        # examples (CFG dropout)
        uncond = None
        for b in self.dataset.all_size_bucket_datasets():
            if b.uncond_embeddings:
                uncond = b.uncond_embeddings
                break
        if not uncond:
            return batch
        n = next(iter(batch.values())).shape[0]
        out = {k: v.clone() for k, v in batch.items()}
        for i in range(n):
            if self._rng.random() < frac:
                for k, v in uncond.items():
                    if k in out:
                        out[k][i] = v
        return out

    def __next__(self) -> Tuple[Tuple[int, int, int], Dict[str, torch.Tensor]]:
        if self._iter is None:
            self._iter = self.dataset.iter_epoch(self.epoch)
        try:
            size_bucket, batch = next(self._iter)
        except StopIteration:
            self.epoch += 1
            self.num_batches_pulled = 0
            self._iter = self.dataset.iter_epoch(self.epoch)
            size_bucket, batch = next(self._iter)
        self.num_batches_pulled += 1
        return size_bucket, self._maybe_apply_uncond(batch)
