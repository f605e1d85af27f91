"""Predictor cache — a bounded LRU of per-shape predictors (counterpart
of ``mxnet_tpu/serving/cache.py``).

In the JAX package each entry is one jitted XLA program for one padded
shape ``(batch_bucket,) + feature_key``. In the port an entry is a
:class:`Predictor` for one padded shape: on the card it captures the
block's inference forward at that shape as a CUDA graph when it is built
(``gluon/cached_graph.py``), and each call copies the padded batch into
the graph's static input, replays it and copies the outputs straight to
host numpy. The graph reads the block's parameters where they live, so
an in-place reload reaches the next call without a capture; a rebound
parameter makes the entry capture anew. On the CPU, which a caller asks
for explicitly, the entry runs the block eagerly. The LRU bound and the
hit/miss/eviction counters are the JAX package's; an evicted or
dropped entry releases its graph and pool.

Outputs reach the host as numpy arrays of their own dtype, but for
bfloat16, which numpy lacks here: those are copied to the host as
float32, which holds every bfloat16 value exactly (the JAX package
returns an ``ml_dtypes`` bfloat16 array).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd as _autograd
from ..base import MXNetError
from ..gluon import cached_graph as _cg

__all__ = ["Predictor", "PredictorCache"]


def _host(t):
    """``t`` copied to a host numpy array (bfloat16 as float32, exact)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class Predictor:
    """Inference of ``block`` at one padded ``shape`` of ``dtype`` on
    ``device``, in predict mode (ref: CompiledPredictor).

    On a CUDA device the constructor captures the forward (``capture_s``
    and ``pool_bytes`` describe the graph); on the CPU nothing is built
    and every call runs the block eagerly.
    ``__call__(x_padded)`` returns ``(outputs, treedef)``: a list of numpy
    arrays and None for a single tensor output, or the output's type
    (tuple/list) to rebuild a sequence of tensors."""

    def __init__(self, block, device, shape, dtype="float32"):
        self._block = block
        self.device = torch.device(device)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._program = None
        self.capture_s = 0.0
        self.pool_bytes = None
        if self.device.type == "cuda":
            self._capture()

    @property
    def ready(self) -> bool:
        """True once the forward is captured: a call replays it (ref:
        ``CompiledPredictor.ready``); always True on the CPU, where a
        call runs the block eagerly."""
        return self._program is not None or self.device.type == "cpu"

    def _capture(self):
        x = torch.from_numpy(np.zeros(self.shape, self.dtype)).to(
            self.device)
        with _autograd.pause():
            self._program = _cg.capture(_cg.CudaGraphs(), self._block,
                                        (x,), {}, False, self.device)
        self.capture_s = self._program.capture_s
        self.pool_bytes = self._program.pool_bytes

    def __call__(self, x_padded):
        x = torch.from_numpy(np.ascontiguousarray(x_padded))
        if self._program is None:
            with torch.inference_mode(), _autograd.pause():
                out = self._block(x.to(self.device))
            if isinstance(out, torch.Tensor):
                return [_host(out)], None
            return [_host(o) for o in out], type(out)
        if tuple(x.shape) != self.shape:
            raise MXNetError(f"predictor for {self.shape} called with "
                             f"{tuple(x.shape)}")
        prog = self.replay(x)
        outs = [_host(o) for o in prog.out]
        return outs, None if prog.tree is None else prog.tree[0]

    def replay(self, x=None):
        """Copy ``x`` (any device) into the graph's static input, unless
        None, and replay the graph, capturing it anew first if a parameter
        was rebound; returns the program, whose ``out`` holds the outputs
        until the next replay."""
        if self._program is None:
            raise MXNetError(f"no graph to replay on {self.device}")
        if self._program.stale(self._block):
            self.close()
            self._capture()
        prog = self._program
        if x is not None:
            prog.load([x])
        prog.replay_forward()
        return prog

    def close(self):
        """Release the graph and its pool (eviction)."""
        prog, self._program = self._program, None
        if prog is not None:
            prog.release()


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
                _, old = self._lru.popitem(last=False)
                old.close()
                self.evictions += 1
        return entry, False

    def contains(self, key) -> bool:
        """Whether ``key`` is cached (no LRU touch, no count): the server
        asks before a batch so that a miss's build is timed."""
        with self._lock:
            return key in self._lru

    def drop_where(self, predicate) -> int:
        """Drop and release every entry whose key satisfies ``predicate``
        (counted as evictions); returns how many went. The fleet's
        page-out and tenant removal: a cold tenant's graphs and pools
        are freed."""
        with self._lock:
            doomed = [self._lru.pop(k) for k in list(self._lru)
                      if predicate(k)]
            self.evictions += len(doomed)
        for entry in doomed:
            entry.close()
        return len(doomed)

    def clear(self) -> None:
        """Drop and release every entry (not counted as evictions)."""
        with self._lock:
            doomed = list(self._lru.values())
            self._lru.clear()
        for entry in doomed:
            entry.close()

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def entries(self) -> list:
        """[(key, entry)] from least to most recently used."""
        with self._lock:
            return list(self._lru.items())

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._lru),
                    "max_entries": self.max_entries,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "hit_rate": round(self.hits / total, 4) if total else None,
                    "last_build_s": self.last_build_s}
