"""Predictor cache — a bounded LRU of per-shape predictors (counterpart
of ``mxnet_tpu/serving/cache.py``).

In the JAX package each entry is one jitted XLA program for one padded
shape ``(batch_bucket,) + feature_key``. The port runs the block eagerly,
so an entry is a :class:`Predictor` bound to one padded shape: it moves
the padded batch to the server's device, runs the block under
``torch.inference_mode()`` and brings the outputs back as numpy arrays.
It reads the block's *current* parameters on every call. The LRU bound
and the hit/miss/eviction counters are the JAX package's; a later
capture of each entry as a CUDA graph will make the entries hold real
per-shape state.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["Predictor", "PredictorCache"]


class Predictor:
    """Inference of ``block`` at one padded shape on ``device``.

    ``__call__(x_padded)`` returns ``(outputs, treedef)``: a list of numpy
    arrays and None for a single tensor output, or the output's type
    (tuple/list) to rebuild a sequence of tensors."""

    def __init__(self, block, device, shape=None):
        self._block = block
        self.device = torch.device(device)
        self.shape = None if shape is None else tuple(shape)

    def __call__(self, x_padded):
        x = torch.from_numpy(np.ascontiguousarray(x_padded))
        with torch.inference_mode():
            out = self._block(x.to(self.device))
        if isinstance(out, torch.Tensor):
            return [out.cpu().numpy()], None
        return [o.cpu().numpy() for o in out], type(out)


class PredictorCache:
    """Bounded LRU over :class:`Predictor` entries.

    ``get(key, builder)`` returns ``(entry, hit)``; a miss invokes
    ``builder()`` and may evict the least-recently-used entry.
    Thread-safe, though the serving worker is the only caller in steady
    state."""

    def __init__(self, max_entries=16):
        if max_entries < 1:
            raise ValueError("PredictorCache needs max_entries >= 1")
        self.max_entries = int(max_entries)
        self._lru = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.last_build_s = None

    def get(self, key, builder):
        with self._lock:
            entry = self._lru.get(key)
            if entry is not None:
                self._lru.move_to_end(key)
                self.hits += 1
                return entry, True
        t0 = time.perf_counter()
        entry = builder()
        build_s = time.perf_counter() - t0
        with self._lock:
            raced = self._lru.get(key)
            if raced is not None:         # concurrent builder won
                self._lru.move_to_end(key)
                self.hits += 1
                return raced, True
            self.misses += 1
            self.last_build_s = round(build_s, 4)
            self._lru[key] = entry
            while len(self._lru) > self.max_entries:
                self._lru.popitem(last=False)
                self.evictions += 1
        return entry, False

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._lru),
                    "max_entries": self.max_entries,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "hit_rate": round(self.hits / total, 4) if total else None,
                    "last_build_s": self.last_build_s}
