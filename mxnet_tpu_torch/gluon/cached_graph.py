"""The port's CachedOp: a hybridized block's calls, and a serving
predictor's forward, as CUDA graphs (counterpart of
``HybridBlock._build_fn`` / ``_call_cached`` in
``mxnet_tpu/gluon/block.py`` and of ``CompiledPredictor`` in
``mxnet_tpu/serving/cache.py``).

The JAX package lowers a hybridized block to one ``jax.jit`` program per
(mode, input shapes, device). The port captures one :class:`Program`
per (mode, recording, input shapes, dtypes and ``requires_grad``,
device): the eager forward, run on a side stream to warm up, then
captured into a CUDA graph with a private memory pool; under
``autograd.record()`` also the backward of its outputs, captured into a
second graph in the same pool and replayed by a
``torch.autograd.Function`` whose inputs are the call's tensors and the
block's trainable parameters (so ``autograd.backward`` finds their
leaves and honours ``grad_req``). A graph bakes in addresses, random
offsets and output buffers, so the JAX package's semantics are kept by
hand:

1. Parameters are read at call time. The graphs read them where they
   live, so an in-place change (``load_state_dict``, an optimizer step)
   reaches the next replay. Before a replay the program checks the
   addresses it captured; a parameter rebound to new storage makes the
   block capture anew.
2. Each call draws fresh dropout bits. Every generator the warm-up drew
   from is registered with the graph, so a replay draws at the
   generator's current offset and advances it, as an eager call does:
   ``mx.random.seed`` reproduces the masks.
3. Outputs are fresh tensors: the static outputs are cloned, and so are
   the static gradients (``AccumulateGrad`` could otherwise keep the
   graph's buffer as a parameter's ``.grad``).
4. Auxiliary state is written once per call: BatchNorm's running
   statistics are updated in place inside the forward graph, and the
   warm-up and the capture leave the buffers and the generators as they
   found them.
5. Hybridized blocks nested in a hybridized block run inside its
   program: while a program's forward runs eagerly on a thread (warm-up,
   capture, :func:`in_capture`), every hybridized block called runs its
   eager forward.

A program waiting for its backward is busy; a second call at the same
key meanwhile (two forwards before one backward) captures another
program. :class:`GraphCache` holds this bookkeeping and takes its capture
backend as an argument: :class:`CudaGraphs` on the card.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
from torch import nn
from torch.autograd.function import once_differentiable
from torch.nn.parameter import is_lazy

from .. import _dispatch
from .. import autograd as _autograd
from .. import kernels as _kernels
from .. import random as _random
from ..base import MXNetError

__all__ = ["CudaGraphs", "GraphCache", "Program", "WARMUP_ITERS", "capture",
           "in_capture", "in_program", "structure_changed"]

WARMUP_ITERS = 2          # eager passes on a side stream before a capture

_local = threading.local()
_capture_lock = threading.Lock()     # one capture at a time in the process
_structure = [0]          # bumped whenever a block registers a child,
                          # parameter or buffer


def structure_changed() -> None:
    """A block registered a child, a parameter or a buffer: programs
    list their block's tensors anew before the next replay."""
    _structure[0] += 1


def in_capture() -> bool:
    """True while a program's forward runs eagerly on this thread (its
    warm-up or capture): hybridized blocks then run their eager forward
    inside it (ref: ``_rng.in_trace()``)."""
    return getattr(_local, "depth", 0) > 0


def in_program() -> bool:
    """True while a hybridized block's forward runs on this thread as its
    program: captured on the card, or eagerly where the backend takes no
    program (the CPU). Control flow then takes the path the JAX package
    traces (``ops.control_flow``): no host read of a device value."""
    return in_capture() or getattr(_local, "program", 0) > 0


@contextlib.contextmanager
def _in_program():
    _local.program = getattr(_local, "program", 0) + 1
    try:
        yield
    finally:
        _local.program -= 1


@contextlib.contextmanager
def _inside():
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


class CudaGraphs:
    """The capture backend on the card: warm-up on a side stream,
    ``torch.cuda.graph`` into a private pool, the dropout generators
    registered before capture.

    Captures run one at a time in the process (``_capture_lock``), in
    ``capture_error_mode`` "thread_local": only the capturing thread is
    barred from calls that are unsafe during a capture, so other threads
    may replay graphs, allocate, and copy answers to the host meanwhile
    (a respawned server capturing beside a serving one, a decode engine
    beside a predictor). In the default "global" mode any such call on
    another thread fails, and the capture with it."""

    capture_error_mode = "thread_local"
    _warm_streams = {}             # device -> its one warm-up stream

    @staticmethod
    def accepts(device):
        return device.type == "cuda"

    @staticmethod
    def new_pool(device):
        with torch.cuda.device(device):
            return torch.cuda.graph_pool_handle()

    @staticmethod
    def warm_up(fn, device):
        """Run ``fn`` on the device's warm-up stream (callers hold
        ``_capture_lock``). One stream serves every capture: cuBLAS keeps
        a workspace (32 MiB on Hopper) per thread and stream for the
        life of the process, so a fresh stream per capture grew device
        memory at every capture, up to the size of PyTorch's stream
        pool."""
        side = CudaGraphs._warm_streams.get(str(device))
        if side is None:
            side = torch.cuda.Stream(device)
            CudaGraphs._warm_streams[str(device)] = side
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_ITERS):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)

    @staticmethod
    def capture(fn, pool, generators, device):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            for g in generators:
                graph.register_generator_state(g)
            with torch.cuda.graph(
                    graph, pool=pool,
                    capture_error_mode=CudaGraphs.capture_error_mode):
                out = fn()
        return graph, out

    @staticmethod
    def pool_bytes(pool, device):
        """Bytes of the segments the pool holds on ``device``."""
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if s.get("device") == device.index
                   and tuple(s.get("segment_pool_id", ())) == tuple(pool))


class Program:
    """One captured call of a block at one key: static inputs, the forward
    graph and, when recording, the backward graph (one private pool),
    static outputs and gradients, the dropout bits the forward graph
    draws, the kernel launches each graph runs and the parameter
    addresses it reads."""

    def __init__(self):
        self.fwd = self.bwd = None
        self.static_in = []        # one buffer per tensor input
        self.out, self.tree = [], None
        self.bits = []             # the forward graph's dropout bits
        self.generators = 0        # dropout generators the graph draws from
        self.fwd_launches, self.bwd_launches = {}, {}
        self.n_inputs = 0          # tensor inputs + trainable parameters
        self.grad_of = []          # input positions the backward fills
        self.targets = []          # the tensors at those positions
        self.gout, self.grads = [], []
        self.slots, self.addresses, self.structure = [], (), None
        self.busy = self.retired = self.released = False
        self.generation = 0        # forward replays so far
        self.capture_s = 0.0
        self.pool_bytes = None

    def stale(self, block) -> bool:
        """A parameter or buffer of ``block`` was rebound, or its
        requires_grad changed, since the capture."""
        if self.structure != _structure[0]:
            self.slots, self.structure = _slots(block), _structure[0]
        return _addresses(self.slots) != self.addresses

    def load(self, tensors):
        with torch.no_grad():
            for s, t in zip(self.static_in, tensors):
                if s.data_ptr() != t.data_ptr():
                    s.copy_(t, non_blocking=True)

    def replay_forward(self):
        self.fwd.replay()
        self.generation += 1
        _kernels.add_launches(self.fwd_launches)
        _random.record_drawn(self.bits)

    def replay_backward(self, grads):
        with torch.no_grad():        # grads are materialized: no None
            for s, g in zip(self.gout, grads):
                if s is not None:
                    s.copy_(g)
        self.bwd.replay()
        _kernels.add_launches(self.bwd_launches)

    def retire(self):
        """Release now, or once the pending backward has run."""
        self.retired = True
        if not self.busy:
            self.release()

    def release(self):
        for graph in (self.fwd, self.bwd):
            if graph is not None:
                graph.reset()
        self.fwd = self.bwd = None
        self.static_in, self.out, self.bits = [], [], []
        self.targets, self.gout, self.grads = [], [], []
        self.released = True


def _addresses(slots):
    out = []
    for table, name in slots:
        t = table.get(name)
        if t is None or is_lazy(t):
            return None
        out.append((t.data_ptr(), t.requires_grad))
    return tuple(out)


def _slots(block):
    return [(table, name) for m in block.modules()
            for table in (m._parameters, m._buffers)
            for name, t in table.items() if t is not None]


def _tensors(args, kwargs):
    return [a for a in itertools.chain(args, (kwargs[k] for k in
                                               sorted(kwargs)))
            if isinstance(a, torch.Tensor)]


def _fill(args, kwargs, static):
    it = iter(static)
    new_args = tuple(next(it) if isinstance(a, torch.Tensor) else a
                     for a in args)
    new_kwargs = {k: next(it) if isinstance(kwargs[k], torch.Tensor)
                  else kwargs[k] for k in sorted(kwargs)}
    return new_args, new_kwargs


def _spec(a):
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), a.dtype, a.requires_grad)
    return ("constant", a)


def _signature(args, kwargs):
    sig = (tuple(_spec(a) for a in args),
           tuple((k, _spec(kwargs[k])) for k in sorted(kwargs)))
    try:
        hash(sig)
    except TypeError:
        raise MXNetError("a hybridized block takes tensors, None and "
                         "hashable constants as arguments") from None
    return sig


def _flatten(out):
    if isinstance(out, torch.Tensor):
        return [out], None
    if isinstance(out, (tuple, list)):
        flat, parts = [], []
        for o in out:
            f, tree = _flatten(o)
            flat.extend(f)
            parts.append((len(f), tree))
        return flat, (list if isinstance(out, list) else tuple, parts)
    raise MXNetError("a hybridized block returns a tensor or a tuple or "
                     f"list of them, not {type(out).__name__}")


def _unflatten(flat, tree):
    if tree is None:
        return flat[0]
    kind, parts = tree
    items, pos = [], 0
    for n, sub in parts:
        items.append(_unflatten(flat[pos:pos + n], sub))
        pos += n
    return kind(items)


@contextlib.contextmanager
def _state_kept(block, extra=()):
    """Run the scope, then put back the block's buffers, the tensors of
    ``extra`` and every dropout generator the scope drew from as they
    were before it."""
    buffers = [b for b in block.buffers() if not is_lazy(b)] + list(extra)
    with torch.no_grad():
        saved = [b.clone() for b in buffers]
    with _random.draws() as seen:
        try:
            yield seen
        finally:
            with torch.no_grad():
                for b, v in zip(buffers, saved):
                    b.copy_(v)
            for g, state in seen.states.items():
                g.set_state(state)


def _record(backend, fn, pool, generators, device):
    """Capture ``fn`` into a graph: (graph, its outputs, the kernel
    launches each replay runs, the dropout bits it draws). The launches
    are those made on the capturing stream during the capture (captures
    are one at a time: ``_capture_lock``), not another thread's."""
    before = _kernels.captured_counts()
    with _random.draws(keep_states=False) as seen:
        graph, out = backend.capture(fn, pool, generators, device)
    after = _kernels.captured_counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    return graph, out, launches, seen.drawn


def _finish(prog, backend, block, pool, device, t0):
    """Note the addresses ``prog`` reads, its pool's bytes and the time
    its capture took since ``t0``."""
    prog.slots, prog.structure = _slots(block), _structure[0]
    prog.addresses = _addresses(prog.slots)
    measure = getattr(backend, "pool_bytes", None)
    prog.pool_bytes = None if measure is None else measure(pool, device)
    prog.capture_s = time.perf_counter() - t0


def capture(backend, block, args, kwargs, recording, device) -> Program:
    """Capture ``block(*args, **kwargs)`` (and, when ``recording``, the
    backward of its outputs to its tensor inputs that require grad and
    its trainable parameters) with ``backend``. The block's state and
    the generators are left as they were."""
    with _capture_lock, torch.inference_mode(False):
        return _capture(backend, block, args, kwargs, recording, device)


def _capture(backend, block, args, kwargs, recording, device):
    prog = Program()
    t0 = time.perf_counter()
    tensors = _tensors(args, kwargs)
    with torch.no_grad():
        static = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  .copy_(t) for t in tensors]
    trainable = [p for p in block.parameters() if p.requires_grad] \
        if recording else []
    if recording:
        for s, t in zip(static, tensors):
            s.requires_grad_(t.requires_grad)
    s_args, s_kwargs = _fill(args, kwargs, static)
    prog.static_in = static
    prog.n_inputs = len(static) + len(trainable)
    positions = [i for i, s in enumerate(static) if s.requires_grad] \
        + list(range(len(static), prog.n_inputs))
    targets = [s for s in static if s.requires_grad] + trainable
    live = {}

    def forward():
        with _inside(), torch.set_grad_enabled(recording):
            flat, live["tree"] = _flatten(block(*s_args, **s_kwargs))
        live["out"] = flat
        return flat

    def backward():
        outs = [o for o in live["out"] if o.requires_grad]
        return torch.autograd.grad(
            outs, targets, [g for g in live["gout"] if g is not None],
            allow_unused=True)

    def warm_step():
        diff = [o for o in forward() if o.requires_grad]
        if recording and diff and targets:
            torch.autograd.grad(diff, targets,
                                [torch.ones_like(o) for o in diff],
                                allow_unused=True)

    pool = backend.new_pool(device)
    with _state_kept(block) as warm:
        backend.warm_up(warm_step, device)
        prog.fwd, prog.out, prog.fwd_launches, prog.bits = _record(
            backend, forward, pool, list(warm.states), device)
        prog.tree, prog.generators = live["tree"], len(warm.states)
        if recording and targets and any(o.requires_grad for o in prog.out):
            live["gout"] = [torch.empty_like(o) if o.requires_grad else None
                            for o in prog.out]
            prog.bwd, grads, prog.bwd_launches, _ = _record(
                backend, backward, pool, [], device)
            prog.gout, prog.grads = live["gout"], list(grads)
            prog.grad_of, prog.targets = positions, targets
    _finish(prog, backend, block, pool, device, t0)
    return prog


class _Hold:
    """Keeps a program busy from its forward replay until its backward
    has run or the autograd graph that would run it is gone."""

    def __init__(self, prog):
        self.prog = prog
        prog.busy = True

    def release(self):
        prog, self.prog = self.prog, None
        if prog is not None:
            prog.busy = False
            if prog.retired:
                prog.release()

    __del__ = release


class _GraphedCall(torch.autograd.Function):
    """A recorded call: the forward graph's replay, and in backward the
    backward graph's. Inputs: the program, the number of tensor inputs,
    the tensor inputs, the trainable parameters."""

    @staticmethod
    def forward(ctx, prog, n_in, *tensors):
        prog.load(tensors[:n_in])
        prog.replay_forward()
        ctx.prog, ctx.generation = prog, prog.generation
        ctx.hold = _Hold(prog)
        outs = tuple(o.clone() for o in prog.out)
        ctx.mark_non_differentiable(*(o for o, s in zip(outs, prog.out)
                                      if not s.requires_grad))
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        prog = ctx.prog
        if prog.released or ctx.generation != prog.generation:
            raise MXNetError("a hybridized block's saved tensors are gone: "
                             "its graphs were released, or the block ran "
                             "again, since this forward")
        prog.replay_backward(grads)
        out = [None] * prog.n_inputs
        for pos, g, target in zip(prog.grad_of, prog.grads, prog.targets):
            out[pos] = torch.zeros_like(target) if g is None else g.clone()
        ctx.hold.release()
        return (None, None, *out)


class GraphCache:
    """One hybridized block's programs, a list per key (ref:
    ``HybridBlock._cached_fns``), captured with ``backend``.

    ``call(block, args, kwargs)`` runs ``block`` on its arguments: eagerly
    on a device the backend does not take (the CPU, which the caller asked
    for), else through the program of its key, captured at the first
    call."""

    def __init__(self, backend):
        self.backend = backend
        self._programs = {}        # key -> [Program]
        self._ready = False        # no deferred parameter left
        self.captures = 0

    def __len__(self):
        return sum(len(p) for p in self._programs.values())

    def programs(self):
        return [p for progs in self._programs.values() for p in progs]

    def clear(self):
        """Drop every program; each releases its graphs and pool now, or
        after the backward it still owes (ref: ``_clear_cached_op``)."""
        programs, self._programs = self.programs(), {}
        self._ready = False
        for prog in programs:
            prog.retire()

    def call(self, block, args, kwargs):
        with _in_program():
            return self._call(block, args, kwargs)

    def _call(self, block, args, kwargs):
        tensors = _tensors(args, kwargs)
        devices = {t.device for t in tensors}
        if len(devices) != 1 or not self.backend.accepts(next(iter(devices))):
            return nn.Module.__call__(block, *args, **kwargs)
        device = devices.pop()
        if _random.replaying():
            raise MXNetError("a hybridized block cannot replay recorded "
                             "dropout bits on the card (its graph draws "
                             "its own); call it inside bits_tape() without "
                             "replay, or run it unhybridized")
        self._ensure_ready(block, args, kwargs)
        params = [p for p in block.parameters() if p.requires_grad]
        recording = _autograd.is_recording() and torch.is_grad_enabled() \
            and (bool(params) or any(t.requires_grad for t in tensors))
        # the per-op AMP policy's epoch: a program captured under another
        # policy casts (or not) where this one does not
        key = (bool(block.training), recording, _signature(args, kwargs),
               device, _dispatch.amp_epoch())
        prog = self._program(key, block, args, kwargs, recording, device)
        if not recording:
            prog.load(tensors)
            prog.replay_forward()
            return _unflatten([o.clone() for o in prog.out], prog.tree)
        outs = _GraphedCall.apply(prog, len(tensors), *tensors, *params)
        return _unflatten(list(outs), prog.tree)

    def _ensure_ready(self, block, args, kwargs):
        """ref: ``_ensure_ready`` — one eager pass under ``pause()``
        materializes deferred parameters, leaving no other trace."""
        if self._ready:
            return
        if any(is_lazy(t) for t in itertools.chain(block.parameters(),
                                                   block.buffers())):
            with _inside(), _autograd.pause(), _state_kept(block):
                nn.Module.__call__(block, *args, **kwargs)
        self._ready = True

    def _program(self, key, block, args, kwargs, recording, device):
        progs = self._programs.get(key, [])
        free = next((p for p in progs if not p.busy), None)
        if free is not None and free.stale(block):
            self.clear()
            self._ensure_ready(block, args, kwargs)
            free = None
        if free is not None:
            return free
        prog = capture(self.backend, block, args, kwargs, recording, device)
        self._programs.setdefault(key, []).append(prog)
        self.captures += 1
        return prog
