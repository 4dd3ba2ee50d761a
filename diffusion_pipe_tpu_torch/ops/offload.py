"""Pinned host memory for the tensors that a checkpointed block keeps from
its forward for its recompute: the "offload_attn", "unsloth" and
"offload_dots" policies of models/layers.py.

Counterpart of the JAX package's save_and_offload_only_these_names /
offload_dot_with_no_batch_dims(offload_dst="pinned_host"), where XLA
schedules the copies. Here a HostQueue does: `append` copies each CUDA
tensor of an item into a new pinned host buffer on a side stream, which
first waits for the work the current stream has queued (the tensor's
producer); the tensor is marked as used by the side stream (record_stream),
so the caching allocator gives its memory to no one before the copy has
read it, and an event marks the copy's end. `popleft` makes the current
stream wait for that event and copies the buffer back to the card on it:
the recompute's first reader of the tensor is queued behind the copy.

The host buffers are carved from pinned slabs of SLAB_BYTES, allocated
once and kept (torch's caching host allocator would round each buffer up
to a power of two: +39% for a Wan ffn output). The carving restarts at the
slabs' start once every held tensor has been taken back. A later copy into
reused memory is queued on the side stream after a wait for the current
stream, which by then holds every copy back out of that memory.

A CPU tensor (the tests) is copied into a CPU buffer of its own and back,
with no streams.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict

import torch

SLAB_BYTES = 1 << 30
_ALIGN = 512

# bytes copied to the host since reset_stats(), the bytes held now and the
# most held at once; `pinned`: the slabs' bytes (kept across resets)
stats: Dict[str, int] = {"bytes": 0, "held": 0, "peak": 0, "pinned": 0}

_side_streams: Dict[int, Any] = {}


def reset_stats() -> None:
    stats.update(bytes=0, held=stats["held"], peak=stats["held"])


_slabs: list = []       # pinned uint8 tensors of SLAB_BYTES (or one larger tensor)
_cursor = [0, 0]        # slab index, byte offset of the next buffer
_live = [0]             # CUDA tensors held now


def _host_buffer(nbytes: int) -> torch.Tensor:
    """nbytes of pinned memory carved from the slabs."""
    i, off = _cursor
    while True:
        if i == len(_slabs):
            _slabs.append(torch.empty(max(SLAB_BYTES, nbytes), dtype=torch.uint8,
                                      pin_memory=True))
            stats["pinned"] += _slabs[-1].numel()
        if off + nbytes <= _slabs[i].numel():
            break
        i, off = i + 1, 0
    _cursor[:] = [i, off + -(-nbytes // _ALIGN) * _ALIGN]
    return _slabs[i][off:off + nbytes]


def _release(nbytes: int, on_cuda: bool) -> None:
    stats["held"] -= nbytes
    if on_cuda:
        _live[0] -= 1
        if _live[0] == 0:
            _cursor[:] = [0, 0]


def _side_stream(device: torch.device):
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _side_streams:
        _side_streams[idx] = torch.cuda.Stream(device=idx)
    return _side_streams[idx]


class _Held:
    """One tensor in host memory: the buffer, the device it came from and
    the event that ends its copy (None on the CPU)."""

    __slots__ = ("host", "device", "event", "nbytes")

    def __init__(self, t: torch.Tensor):
        self.device = t.device
        self.nbytes = t.numel() * t.element_size()
        if t.device.type == "cpu":
            self.host, self.event = t.clone(), None
        else:
            stream = _side_stream(t.device)
            self.host = _host_buffer(self.nbytes).view(t.dtype).view(t.shape)
            _live[0] += 1
            stream.wait_stream(torch.cuda.current_stream(t.device))
            with torch.cuda.stream(stream):
                self.host.copy_(t, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record(stream)
            t.record_stream(stream)
        stats["bytes"] += self.nbytes
        stats["held"] += self.nbytes
        stats["peak"] = max(stats["peak"], stats["held"])

    def back(self) -> torch.Tensor:
        if self.event is None:
            _release(self.nbytes, False)
            return self.host
        torch.cuda.current_stream(self.device).wait_event(self.event)
        out = self.host.to(self.device, non_blocking=True)
        _release(self.nbytes, True)
        return out

    def drop(self) -> None:
        _release(self.nbytes, self.event is not None)


def _map(fn, item):
    if isinstance(item, tuple):
        return tuple(_map(fn, x) for x in item)
    if item is None:
        return None
    return fn(item)


class HostQueue:
    """A FIFO with deque's append / popleft whose tensors (an item may be a
    tensor, None or a tuple of them) wait in pinned host memory."""

    def __init__(self):
        self._items = deque()

    def append(self, item) -> None:
        self._items.append(_map(_Held, item))

    def popleft(self):
        return _map(lambda held: held.back(), self._items.popleft())

    def __len__(self) -> int:
        return len(self._items)

    def __del__(self):
        # items the recompute did not take back (it stops at the last
        # tensor the backward needs) are released with the queue
        for item in self._items:
            _map(lambda held: held.drop(), item)
