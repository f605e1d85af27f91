"""The training step as one program (counterpart of
``mxnet_tpu/parallel/sharded.py``).

The JAX package's ``ShardedTrainer`` compiles the whole step into one
jitted program over a device mesh: the cast to the compute dtype, the
forward, the loss, the backward, the fused guard and the optimizer
update. The port runs the same step on a one-device mesh, and on the
card captures it as **one CUDA graph per input signature** (shapes,
dtypes, compute dtype and whether the step is guarded), the
counterpart of ``jax.jit`` tracing once per shape:

- the trainable parameters (fp32 masters by default) are cast to the
  compute dtype inside the differentiated function, so
  ``torch.autograd.grad`` reaches the masters through the cast; floating
  inputs are cast too, integer ids are not; auxiliary state (BatchNorm's
  running statistics) is not cast and keeps its own dtype;
- the model's outputs go to the loss in fp32 unless the loss is
  ``amp_safe``; the step differentiates ``mean(loss) * loss_scale`` and
  returns the unscaled mean;
- one fused reduction (``guardrails.fused.guard_stats``) gives the
  non-finite flag and the global norm; with an fp16 loss scaler the step
  is guarded: a non-finite step leaves the parameters, the optimizer
  state and the BatchNorm statistics (updated in place by the forward,
  so restored from a copy) bit-unchanged;
- the update runs in place, SGD (with or without momentum) or Adam
  (bias correction from an fp32 device scalar ``t``).

The learning rate, ``t``, ``rescale_grad`` and the loss scale are 0-d
device tensors written before each replay, the counterpart of the JAX
step's traced scalars: a new lr or scale never recaptures. The capture
reuses the machinery of ``gluon/cached_graph.py``: warm-up passes on a
side stream, a private pool, the dropout generators registered with the
graph (each replay draws new bits, as an eager step does), and the
state (parameters, optimizer state, buffers, generators) put back after
the warm-up and the capture, so only replays move it. Before each
replay the program checks the addresses of the parameters and buffers
it captured: a rebound one (``Block.cast``, a reinit) makes the step
capture anew. A capture that fails on the card raises; nothing falls
back to an eager step there. On the CPU, which a caller asks for with
``make_mesh(devices=[mx.cpu()])``, the same step runs eagerly.

Not ported yet (ROADMAP Queue 1 item 4): ``run_steps``, the checkpoint
family, ``remat``, ``guard=`` (``GuardConfig``/``AnomalyMonitor``) and
optimizers other than SGD and Adam; multi-device meshes and sharded
``param_rules`` are Queue 1 item 9. On one device every spec projects to
replication, so ``param_rules`` is accepted and changes nothing.
"""
from __future__ import annotations

import itertools
import re
import time

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.nn.parameter import is_lazy

from .. import autograd as _autograd
from ..base import MXNetError, as_torch_dtype
from ..gluon import cached_graph as _cg
from ..guardrails import fused as _guard
from ..ops import optimizer_op as _ops
from .mesh import PartitionSpec, current_mesh

__all__ = ["ShardedTrainer", "project_spec"]


def project_spec(mesh, spec):
    """``spec`` projected onto ``mesh``: an axis name the mesh does not
    have degrades to replication on that dimension; a dimension sharded
    over several axes keeps the ones the mesh has."""
    out = []
    for a in spec:
        if isinstance(a, (tuple, list)):
            kept = tuple(x for x in a if x in mesh.axis_names)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(a if a is None or a in mesh.axis_names else None)
    return PartitionSpec(*out)


# -- functional optimizer rules ------------------------------------------------
def _lr_at(optimizer):
    """The lr of the next update: the optimizer's (lr schedulers are
    ROADMAP Queue 1 item 4)."""
    return float(optimizer.learning_rate)


def _not_ported_optimizer(opt):
    return MXNetError(
        f"ShardedTrainer has no functional rule for optimizer "
        f"{type(opt).__name__!r} yet (ROADMAP Queue 1 item 4: the other "
        "optimizers); use SGD or Adam, or the eager gluon.Trainer")


def _opt_init_state(opt, w):
    """The optimizer state of weight ``w``: zeros in ``w``'s dtype."""
    name = type(opt).__name__
    if name == "SGD":
        return (torch.zeros_like(w),) if opt.momentum != 0.0 else ()
    if name == "Adam":
        return (torch.zeros_like(w), torch.zeros_like(w))
    raise _not_ported_optimizer(opt)


def _step_lr(opt, lr, t):
    """The lr of step ``t`` as the update takes it: Adam folds its bias
    correction ``sqrt(1 - beta2^t) / (1 - beta1^t)`` in, computed in fp32
    from the 0-d fp32 tensor ``t`` (as the JAX step's traced ``t``)."""
    if type(opt).__name__ == "Adam":
        return lr * (torch.sqrt(1 - opt.beta2 ** t) / (1 - opt.beta1 ** t))
    return lr


def _opt_apply(opt, w, g, state, lr, wd, rescale, clip):
    """One update, out of place: ``(new_w, new_state)``. ``lr`` (from
    :func:`_step_lr`) and ``rescale`` are 0-d fp32 tensors."""
    name = type(opt).__name__
    kw = dict(lr=lr, wd=wd, rescale_grad=rescale, clip_gradient=clip)
    if name == "SGD":
        if not state:
            return _ops._sgd_update(w, g, **kw), ()
        w2, m2 = _ops._sgd_mom_update(w, g, state[0], momentum=opt.momentum,
                                      **kw)
        return w2, (m2,)
    if name == "Adam":
        w2, m2, v2 = _ops._adam_update(w, g, state[0], state[1],
                                       beta1=opt.beta1, beta2=opt.beta2,
                                       epsilon=opt.epsilon, **kw)
        return w2, (m2, v2)
    raise _not_ported_optimizer(opt)


def _queued(name, item):
    def method(self, *args, **kwargs):
        raise MXNetError(f"ShardedTrainer.{name} is not ported yet "
                         f"(ROADMAP Queue 1 item {item})")
    method.__name__ = name
    return method


class ShardedTrainer:
    """Gluon-level front end of the one-program training step (ref: the JAX
    package's ``parallel.ShardedTrainer``)::

        mesh = parallel.make_mesh({"data": 1, "model": 1})
        trainer = parallel.ShardedTrainer(net, loss_fn, "sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            mesh=mesh, compute_dtype="bfloat16")
        loss = trainer.step(x, y)      # one CUDA graph replay on the card

    ``step(*batch)`` takes the model's inputs and, last, the label, as
    numpy arrays or tensors (float64 and int64 arrays become float32 and
    int32, as the JAX package's default types), and returns the mean
    loss as a 0-d tensor on the device, without a host sync;
    ``last_outputs`` holds the model's outputs. The parameters' ``.grad``
    is not touched.
    """

    def __init__(self, block, loss_fn, optimizer, optimizer_params=None,
                 mesh=None, param_rules=None, *, compute_dtype=None,
                 remat=None, master_dtype=None, guard=None):
        from .. import optimizer as opt_mod
        if remat is not None:
            raise MXNetError(f"remat={remat!r} is not ported yet (ROADMAP "
                             "Queue 1 item 4)")
        if guard is not None:
            raise MXNetError("guard= (GuardConfig, AnomalyMonitor) is not "
                             "ported yet (ROADMAP Queue 1 item 4)")
        self._block = block
        self._loss = loss_fn
        self._optimizer = (optimizer if isinstance(optimizer,
                                                   opt_mod.Optimizer)
                           else opt_mod.create(optimizer,
                                               **(optimizer_params or {})))
        # compute_dtype=None takes the process-wide AMP dtype, re-read
        # before each step; master_dtype is the storage dtype of the
        # weights and the optimizer state
        self._explicit_compute_dtype = compute_dtype is not None
        if compute_dtype is None:
            from ..contrib.amp import amp_dtype
            compute_dtype = amp_dtype()
        self._compute_dtype = (as_torch_dtype(compute_dtype)
                               if compute_dtype is not None else None)
        self._master_dtype = (as_torch_dtype(master_dtype)
                              if master_dtype is not None else None)
        if self._compute_dtype is None and self._master_dtype is not None:
            self._compute_dtype = self._master_dtype
        self._mesh = mesh
        # on one device every spec projects to replication, so the rules
        # are only checked
        for pat, spec in param_rules or ():
            re.compile(pat)
            PartitionSpec(*spec)
        self._prepared = False
        self._num_update = 0
        self._scaler = None
        self._resolve_scaler()
        self._guard_state = None
        self._backend = _cg.CudaGraphs()   # captures on the card
        self._programs = {}                # input signature -> Program
        self.last_outputs = None

    def _resolve_scaler(self):
        """(Re)read the compute dtype from the live AMP state when the
        caller did not pin it, and keep an fp16 loss scaler exactly when
        the step computes in fp16."""
        if not self._explicit_compute_dtype:
            from ..contrib.amp import amp_dtype
            cdt = amp_dtype()
            self._compute_dtype = (as_torch_dtype(cdt) if cdt is not None
                                   else self._master_dtype)
        if self._compute_dtype == torch.float16:
            if self._scaler is None:
                from ..contrib.amp import DynamicLossScaler
                self._scaler = DynamicLossScaler()
        else:
            self._scaler = None

    # -- placement -----------------------------------------------------------
    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = current_mesh()
        return self._mesh

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _host(self, b):
        """A batch argument as a tensor: numpy float64 / int64 become
        float32 / int32; tensors keep their dtype."""
        if isinstance(b, torch.Tensor):
            return b
        a = np.asarray(b)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a))

    def _on_device(self, b):
        return self._host(b).to(self.device, non_blocking=True)

    # -- setup ---------------------------------------------------------------
    def _prepare(self, args):
        if self._prepared:
            return
        block, dev = self._block, self.device
        if any(is_lazy(t) for t in itertools.chain(block.parameters(),
                                                   block.buffers())):
            # deferred parameters materialize from one eager pass that
            # leaves no other trace
            inputs = [self._on_device(a) for a in args]
            with _cg._inside(), _autograd.pause(), _cg._state_kept(block):
                nn.Module.__call__(block, *inputs)
        named = [(n, p) for n, p in block.named_parameters()
                 if p.requires_grad]
        mdt = self._master_dtype
        with torch.no_grad():
            for t in itertools.chain(block.parameters(), block.buffers()):
                if t.device != dev:
                    t.data = t.data.to(dev)
            for _, p in named:
                if mdt is not None and p.is_floating_point():
                    p.data = p.data.to(mdt)
        self._named = named
        self._structure = _cg._structure[0]
        self._trainable = [p for _, p in named]
        self._aux = [t for t in itertools.chain(block.parameters(),
                                                block.buffers())
                     if not t.requires_grad]
        self._states = [_opt_init_state(self._optimizer, p)
                        for p in self._trainable]
        self._guard_state = _guard.init_guard_state(dev)
        self._prepared = True

    def _check_params(self):
        """A block registered a child, a parameter or a buffer: the
        trainer's parameters must still be the block's."""
        named = [(n, p) for n, p in self._block.named_parameters()
                 if p.requires_grad]
        if [(n, id(p)) for n, p in named] != \
                [(n, id(p)) for n, p in self._named]:
            raise MXNetError("the block's trainable parameters changed after "
                             "the ShardedTrainer was prepared; make a new "
                             "trainer for the new parameters")
        self._structure = _cg._structure[0]

    def prepare(self, *example_args):
        """Place the parameters and create the optimizer state without
        running a step."""
        self._prepare(example_args)

    # -- the step ------------------------------------------------------------
    def _loss_and_grads(self, inputs, label, lscale=1.0):
        """The differentiated half of the step on device tensors: the
        trainable parameters and floating inputs cast to the compute
        dtype, the forward in training mode, the loss, and
        ``torch.autograd.grad`` of ``mean(loss) * lscale`` into the
        trainable parameters (zeros where the loss does not reach).
        Returns (mean loss, gradients, model outputs)."""
        block, loss_fn, cdt = self._block, self._loss, self._compute_dtype
        with _autograd.record():
            if cdt is not None:
                cast = {n: p.to(cdt) if p.is_floating_point() else p
                        for n, p in self._named}
                xs = [x.to(cdt) if x.is_floating_point() else x
                      for x in inputs]
                out = functional_call(block, cast, tuple(xs))
            else:
                out = block(*inputs)
            outs, _ = _cg._flatten(out)
            if not getattr(loss_fn, "amp_safe", False):
                outs = [o.float() if o.is_floating_point() else o
                        for o in outs]
            per_sample = loss_fn(outs[0] if len(outs) == 1 else outs, label)
            loss = torch.mean(per_sample.float())
        grads = torch.autograd.grad(loss * lscale, self._trainable,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._trainable, grads)]
        return loss.detach(), grads, [o.detach() for o in outs]

    def _body(self, inputs, label, scalars):
        """One training step on device tensors, in place; ``scalars`` a
        (4,) fp32 device tensor (lr, t, rescale_grad, loss scale). Returns
        [loss, finite, global norm, *model outputs]."""
        opt = self._optimizer
        guarded = self._scaler is not None
        lr, t, rescale, lscale = scalars.unbind()
        with torch.no_grad():
            saved = [a.clone() for a in self._aux] if guarded else None
        loss, grads, outs = self._loss_and_grads(inputs, label, lscale)
        with torch.no_grad():
            inv = 1.0 / lscale
            finite, gnorm = _guard.guard_stats(grads, loss)
            gnorm = gnorm * inv
            rescale_all = rescale * inv
            clip = (opt.clip_gradient if opt.clip_gradient is not None
                    else -1.0)
            lr_t = _step_lr(opt, lr, t)
            for i, (w, g, s) in enumerate(zip(self._trainable, grads,
                                              self._states)):
                w2, s2 = _opt_apply(opt, w, g, s, lr_t, opt._get_wd(i),
                                    rescale_all, clip)
                if guarded:
                    w2 = torch.where(finite, w2, w)
                    s2 = _guard.select(finite, s2, s)
                w.copy_(w2)
                for a, b in zip(s, s2):
                    a.copy_(b)
            if guarded:
                for a, a0 in zip(self._aux, saved):
                    a.copy_(torch.where(finite, a, a0))
                for c, v in zip(self._guard_state, _guard.update_guard_state(
                        self._guard_state, finite)):
                    c.copy_(v)
        return [loss, finite, gnorm] + outs

    def _scalar_tensor(self, lr, t, rescale, lscale):
        return torch.tensor([lr, t, rescale, lscale], dtype=torch.float32)

    def _eager_step(self, batch, scalars):
        xs = [self._on_device(b) for b in batch]
        with _cg._inside():
            return self._body(xs[:-1], xs[-1],
                              scalars.to(self.device, non_blocking=True))

    def _graph_step(self, batch, scalars):
        tensors = [self._host(b) for b in batch] + [scalars]
        key = (tuple((tuple(x.shape), x.dtype) for x in tensors),
               self._compute_dtype, self._scaler is not None)
        prog = self._programs.get(key)
        if prog is not None and prog.stale(self._block):
            # a parameter or buffer was rebound (Block.cast, a reinit):
            # every program reads and updates the old storage
            self._release()
            prog = None
        if prog is None:
            prog = self._programs[key] = self._capture(tensors)
        prog.load(tensors)
        prog.replay_forward()
        loss, finite, gnorm, *outs = prog.out
        return [loss.clone(), finite, gnorm] + [o.clone() for o in outs]

    def _capture(self, tensors):
        """Warm up and capture the step at the signature of ``tensors``
        (the batch, then the scalars) with the backend; the parameters,
        the optimizer state, the buffers, the guard counters and the
        generators are left as they were."""
        backend, dev, block = self._backend, self.device, self._block
        prog = _cg.Program()
        t0 = time.perf_counter()
        with torch.no_grad():
            prog.static_in = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                              .copy_(x) for x in tensors]
        *inputs, label, scalars = prog.static_in

        def step():
            with _cg._inside():
                return self._body(inputs, label, scalars)

        kept = list(block.parameters()) + [s for st in self._states
                                           for s in st] \
            + list(self._guard_state)
        pool = backend.new_pool(dev)
        with _cg._capture_lock, torch.inference_mode(False), \
                _cg._state_kept(block, kept) as warm:
            backend.warm_up(step, dev)
            if dev.type == "cuda":
                # the warm-up's blocks back to the device: the capture's
                # private pool needs about as much again
                torch.cuda.empty_cache()
            prog.fwd, prog.out, prog.fwd_launches, prog.bits = _cg._record(
                backend, step, pool, list(warm.states), dev)
            prog.generators = len(warm.states)
        _cg._finish(prog, backend, block, pool, dev, t0)
        return prog

    def _release(self):
        """Drop every captured program, its graph and its pool."""
        programs, self._programs = list(self._programs.values()), {}
        for prog in programs:
            prog.release()

    def step(self, *batch):
        """One training step; the last positional argument is the label.
        Returns the mean loss as a 0-d fp32 tensor on the device. On the
        card the step is a CUDA graph replay (captured at the first step
        of each input signature); on the CPU it runs eagerly."""
        self._prepare(batch[:-1])
        if self._structure != _cg._structure[0]:
            self._check_params()
        self._resolve_scaler()
        self._num_update += 1
        t = self._num_update
        self._optimizer.num_update = t
        lscale = self._scaler.loss_scale if self._scaler is not None else 1.0
        scalars = self._scalar_tensor(_lr_at(self._optimizer), t,
                                      self._optimizer.rescale_grad, lscale)
        backend = self._backend
        if backend is not None and backend.accepts(self.device):
            loss, finite, gnorm, *outs = self._graph_step(batch, scalars)
        else:
            loss, finite, gnorm, *outs = self._eager_step(batch, scalars)
        self.last_outputs = outs
        if self._scaler is not None:
            # the one host read of an fp16 step: the scale follows the flag
            ok, _, _ = _guard.host_fetch(finite, loss, gnorm)
            self._scaler.update_scale(not ok)
        return loss

    def evaluate(self, *batch):
        """The model's forward in predict mode and the mean loss, in the
        parameters' own dtype (no cast to the compute dtype)."""
        self._prepare(batch[:-1])
        xs = [self._on_device(b) for b in batch]
        with _autograd.pause(train_mode=False):
            outs, _ = _cg._flatten(self._block(*xs[:-1]))
            per_sample = self._loss(outs[0] if len(outs) == 1 else outs,
                                    xs[-1])
            loss = torch.mean(per_sample.float())
        self.last_outputs = outs
        return loss

    # -- counters and hyperparameters ------------------------------------------
    @property
    def skipped_steps(self):
        """Steps skipped on a non-finite gradient so far (one host read
        of the in-step counter)."""
        if self._guard_state is None:
            return 0
        return int(_guard.host_fetch(self._guard_state[0])[0])

    @property
    def num_update(self):
        """Completed optimizer updates."""
        return self._num_update

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    run_steps = _queued("run_steps", 4)
    save_states = _queued("save_states", 4)
    load_states = _queued("load_states", 4)
    save_checkpoint = _queued("save_checkpoint", 4)
    load_checkpoint = _queued("load_checkpoint", 4)
    checkpoint = _queued("checkpoint", 4)
    restore = _queued("restore", 4)
    rebuild_mesh = _queued("rebuild_mesh", 9)
