"""Aspect-ratio / size / frame bucketing math and deterministic shuffles.

The port's copy of diffusion_pipe_tpu/data/bucketing.py, the same functions
on the same inputs: AR buckets geomspaced in log space, frame buckets with a
forced image bucket, size buckets w = sqrt(area * ar) rounded to the model
multiple, closest-bucket assignment in log-AR space, the explicit
size_buckets mode, and the seeded shuffles that make the data order the
same in both packages.
"""

from __future__ import annotations

import hashlib
import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..common import round_to_nearest_multiple


def seed_from_hash(obj) -> int:
    """Deterministic seed from any printable object (reference
    dataset.py:80-81)."""
    h = hashlib.md5(str(obj).encode()).hexdigest()
    return int(h, 16) % (2**32)


def shuffle_with_seed(l: list, seed=None) -> None:
    """In-place seeded shuffle that does not disturb global RNG state
    (reference dataset.py:40-44)."""
    rng_state = random.getstate()
    random.seed(seed)
    random.shuffle(l)
    random.setstate(rng_state)


def shuffle_captions(
    captions: List[str], count: int = 0, delimiter: str = ", ",
    caption_prefix: str = "",
) -> List[str]:
    """cache_shuffle_num caption augmentation (reference dataset.py:46-56)."""
    if count == 0:
        return [caption_prefix + c for c in captions]

    def shuffle_one(caption: str) -> str:
        split = caption.split(delimiter)
        random.shuffle(split)
        return delimiter.join(split)

    return [
        caption_prefix + shuffle_one(c) for c in captions for _ in range(count)
    ]


def dedup_and_sort(values) -> np.ndarray:
    return np.array(sorted(set(float(v) for v in values)))


def build_ar_buckets(
    enable_ar_bucket: bool,
    ar_buckets: Optional[Sequence] = None,
    min_ar: float = 0.5,
    max_ar: float = 2.0,
    num_ar_buckets: int = 9,
) -> np.ndarray:
    """Reference dataset.py:498-505. ar_buckets entries may be floats or
    [w, h] pairs."""
    if not enable_ar_bucket:
        return np.array([1.0])
    if ar_buckets is not None:
        ars = [
            (a[0] / a[1]) if isinstance(a, (list, tuple)) else float(a)
            for a in ar_buckets
        ]
        return dedup_and_sort(ars)
    return dedup_and_sort(np.geomspace(min_ar, max_ar, num=num_ar_buckets))


def build_frame_buckets(frame_buckets: Optional[Sequence[int]] = None) -> np.ndarray:
    """Always includes the image bucket 1 (reference dataset.py:507-512)."""
    buckets = list(frame_buckets or [1])
    if 1 not in buckets:
        buckets.append(1)
    return np.array(sorted(buckets))


def find_closest_ar_bucket(log_ars: np.ndarray, width: int, height: int) -> int:
    """Index of the AR bucket closest in log space."""
    log_ar = math.log(width / height)
    return int(np.argmin(np.abs(log_ars - log_ar)))


def find_frame_bucket(frame_buckets: np.ndarray, frames: int) -> Optional[int]:
    """Largest frame bucket <= frames; None if even the smallest doesn't fit."""
    candidates = frame_buckets[frame_buckets <= frames]
    if len(candidates) == 0:
        return None
    return int(candidates[-1])


def size_bucket_from_resolution(
    ar: float, resolution: float, frames: int, round_to_multiple: int
) -> Tuple[int, int, int]:
    """(w, h, frames) for an AR bucket at a training resolution
    (reference dataset.py:419-425: area = res^2, w = sqrt(area*ar))."""
    area = resolution**2
    w = math.sqrt(area * ar)
    h = area / w
    return (
        round_to_nearest_multiple(w, round_to_multiple),
        round_to_nearest_multiple(h, round_to_multiple),
        frames,
    )


def find_closest_size_bucket(
    size_buckets: np.ndarray, width: int, height: int, frames: int
) -> Optional[Tuple[int, int, int]]:
    """Explicit size_buckets mode: closest log-AR among buckets whose frame
    count fits (reference dataset.py:459-465 semantics). size_buckets is an
    array of (w, h, f) sorted by f descending."""
    log_ar = math.log(width / height)
    fitting = [b for b in size_buckets if b[2] <= frames]
    if not fitting:
        return None
    best = min(
        fitting, key=lambda b: abs(math.log(b[0] / b[1]) - log_ar)
    )
    return tuple(int(x) for x in best)
