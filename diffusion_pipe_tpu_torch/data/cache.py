"""Fingerprinted sharded tensor cache: SQLite metadata + binary shards.

The port's copy of diffusion_pipe_tpu/data/cache.py, with the same files
on disk: append-only `shard_N.bin` files of safetensors records and a
SQLite `cache.db` (items table: idx, shard, offset, size; meta table: the
fingerprint). A fingerprint mismatch clears and rebuilds; fills resume from
the longest cached prefix. So a cache written by either package reads in
the other. Records are written and read through ..safetensors_io, as CPU
torch tensors (numpy arrays are taken on write).
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from .. import safetensors_io

DEFAULT_SHARD_SIZE = 10 * 2**30  # 10 GB


class Cache:
    """Append-only record cache addressed by integer index."""

    def __init__(self, cache_dir, fingerprint: str, shard_size: int = DEFAULT_SHARD_SIZE):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.shard_size = shard_size
        self.db_path = self.cache_dir / "cache.db"
        self.db = sqlite3.connect(self.db_path)
        self.db.execute(
            "CREATE TABLE IF NOT EXISTS meta (key TEXT PRIMARY KEY, value TEXT)"
        )
        self.db.execute(
            "CREATE TABLE IF NOT EXISTS items ("
            "idx INTEGER PRIMARY KEY, shard INTEGER, offset INTEGER, size INTEGER)"
        )
        self.db.commit()
        stored = self._get_meta("fingerprint")
        if stored is not None and stored != fingerprint:
            self.clear()
        self._set_meta("fingerprint", fingerprint)

    def _get_meta(self, key):
        row = self.db.execute(
            "SELECT value FROM meta WHERE key=?", (key,)
        ).fetchone()
        return row[0] if row else None

    def _set_meta(self, key, value):
        self.db.execute(
            "INSERT OR REPLACE INTO meta (key, value) VALUES (?, ?)", (key, value)
        )
        self.db.commit()

    def clear(self):
        self._invalidate_reader()
        self.db.execute("DELETE FROM items")
        self.db.execute("DELETE FROM meta")
        self.db.commit()
        for shard in self.cache_dir.glob("shard_*.bin"):
            shard.unlink()

    def __len__(self) -> int:
        row = self.db.execute("SELECT COUNT(*) FROM items").fetchone()
        return int(row[0])

    def _shard_path(self, shard: int) -> Path:
        return self.cache_dir / f"shard_{shard}.bin"

    def _current_shard(self):
        shard = 0
        while True:
            p = self._shard_path(shard)
            if not p.exists() or p.stat().st_size < self.shard_size:
                return shard
            shard += 1

    def write(self, idx: int, tensors: Dict[str, torch.Tensor],
              metadata: Optional[Dict[str, str]] = None):
        # Treat None values as absent; encode presence in metadata.
        tensors = {k: v for k, v in tensors.items() if v is not None}
        blob = safetensors_io.save(tensors, metadata=metadata or {})
        shard = self._current_shard()
        path = self._shard_path(shard)
        with open(path, "ab") as f:
            offset = f.tell()
            f.write(blob)
        self.db.execute(
            "INSERT OR REPLACE INTO items (idx, shard, offset, size) "
            "VALUES (?, ?, ?, ?)",
            (idx, shard, offset, len(blob)),
        )
        self.db.commit()
        self._invalidate_reader()

    def _native_reader(self):
        """mmap + prefetch-thread reader (native/cache_reader.cpp); None
        when the toolchain is unavailable. Rebuilt lazily after writes.
        `last_reader` says which reader served the last read ("native" or
        "python")."""
        if getattr(self, "_reader", None) is not None:
            return self._reader
        if getattr(self, "_reader_failed", False):
            return None
        try:
            from .native_cache import MISSING, NativeCacheReader, available

            if not available():
                raise RuntimeError("no native reader")
            rows = self.db.execute(
                "SELECT idx, shard, offset, size FROM items"
            ).fetchall()
            if not rows:
                raise RuntimeError("empty cache")
            n = max(r[0] for r in rows) + 1
            items = np.full((n, 3), MISSING, np.uint64)
            max_shard = 0
            for i, shard, offset, size in rows:
                items[i] = (shard, offset, size)
                max_shard = max(max_shard, shard)
            paths = [self._shard_path(s) for s in range(max_shard + 1)]
            self._reader = NativeCacheReader(paths, items)
        except Exception:
            self._reader_failed = True
            self._reader = None
        return self._reader

    def _invalidate_reader(self):
        if getattr(self, "_reader", None) is not None:
            self._reader.close()
        self._reader = None
        self._reader_failed = False

    def prefetch(self, indices):
        """Warm pages for upcoming records (no-op without the native lib)."""
        r = self._native_reader()
        if r is not None:
            r.prefetch(indices)

    def read(self, idx: int, with_metadata: bool = False):
        blob = None
        r = self._native_reader()
        if r is not None:
            blob = r.read(idx)
        self.last_reader = "python" if blob is None else "native"
        if blob is None:
            row = self.db.execute(
                "SELECT shard, offset, size FROM items WHERE idx=?", (idx,)
            ).fetchone()
            if row is None:
                raise KeyError(idx)
            shard, offset, size = row
            with open(self._shard_path(shard), "rb") as f:
                f.seek(offset)
                blob = f.read(size)
        tensors = safetensors_io.load(blob)
        if not with_metadata:
            return tensors
        return tensors, safetensors_io.metadata(blob)

    def has(self, idx: int) -> bool:
        return (
            self.db.execute(
                "SELECT 1 FROM items WHERE idx=?", (idx,)
            ).fetchone()
            is not None
        )

    def num_contiguous(self) -> int:
        """Largest n such that items 0..n-1 all exist (resumable fills)."""
        n = len(self)
        row = self.db.execute("SELECT MAX(idx) FROM items").fetchone()
        max_idx = row[0]
        if max_idx is None:
            return 0
        return n if max_idx == n - 1 else 0

    def close(self):
        self._invalidate_reader()
        self.db.close()


def map_and_cache(
    items: Iterable[Any],
    map_fn,
    cache_dir,
    fingerprint: str,
    batch_size: int = 1,
    regenerate: bool = False,
) -> Cache:
    """Fill a cache by mapping batches of items: map_fn is a batched encoder
    on the card, so a process-local loop keeps it busy.

    map_fn(list_of_items) -> list of (tensors_dict, metadata_dict_or_None).
    Resumes from the longest cached prefix.
    """
    items = list(items)
    cache = Cache(cache_dir, fingerprint)
    if regenerate:
        cache.clear()
        cache._set_meta("fingerprint", fingerprint)
    start = cache.num_contiguous()
    if start >= len(items):
        return cache
    for i in range(start, len(items), batch_size):
        batch = items[i : i + batch_size]
        results = map_fn(batch)
        for j, res in enumerate(results):
            tensors, metadata = res if isinstance(res, tuple) else (res, None)
            cache.write(i + j, tensors, metadata)
    return cache
