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
  non-finite flag and the global norm; ``guard=`` (a ``GuardConfig``)
  folds ``clip_norm`` into the update's rescale from that norm. A step
  with a guard or an fp16 loss scaler is guarded: a non-finite step
  leaves the parameters, the optimizer state and the BatchNorm
  statistics (updated in place by the forward, so restored from a copy)
  bit-unchanged, and the host half (``guardrails.trainer_mixin``) feeds
  the scaler and the ``AnomalyMonitor``;
- the update runs in place, with the functional rule of each of the
  optimizers the reference has one for (SGD, NAG, Adam, AdamW, LAMB,
  RMSProp, AdaGrad, FTRL, Signum, AdaDelta, Nadam, DCASGD, FTML), each
  weight with its wd and lr multiplier.

The learning rate (per step, from the optimizer's scheduler), ``t``,
``rescale_grad`` and the loss scale are device scalars written before
each replay, the counterpart of the JAX step's traced scalars: a new lr
or scale never recaptures. ``run_steps(*batch, num_steps=n)`` captures
``n`` copies of the step back to back in one graph, with the lrs of its
``n`` updates in one tensor. The capture reuses the machinery of
``gluon/cached_graph.py``: warm-up passes on a side stream, a private
pool, the dropout generators registered with the graph (each replay
draws new bits, as an eager step does), and the state (parameters,
optimizer state, buffers, guard counters, generators) put back after
the warm-up and the capture, so only replays move it. Before each
replay the program checks the addresses of the parameters and buffers
it captured: a rebound one (``Block.cast``, a reinit) makes the step
capture anew. A capture that fails on the card raises; nothing falls
back to an eager step there. On the CPU, which a caller asks for with
``make_mesh(devices=[mx.cpu()])``, the same steps run eagerly.

Telemetry (``observability.instrument``), as the reference records it:
``step`` and ``run_steps`` are ``sharded_trainer.step`` /
``sharded_trainer.run_steps`` spans with the ``data_wait``,
``compiled_step`` and ``guard_fetch`` phases, each phase also observed
into ``mxnet_tpu_step_phase_ms``. ``compiled_step`` wraps the host call
that replays the graph (a span inside the captured function would fire
at the capture only), and a capture, or on the CPU the first eager run
of a signature, is one ``xla_compile`` span and one
``mxnet_tpu_xla_compiles_total``. No span reads the device.

The checkpoint family (``save_states``, ``load_states``,
``save_checkpoint``, ``load_checkpoint``, ``checkpoint``, ``restore``,
``load_checkpoint_resharded``, ``restore_resharded``) writes and reads
the JAX package's files (:mod:`._ckpt`): the master weights, the
auxiliary state and the optimizer state in their storage dtypes, the
update count and the dropout generator's state, so a restored trainer
goes on bit for bit. A load copies into the live tensors in place, so
the captured programs keep their addresses and replay the restored
state without a new capture. ``GuardConfig(ckpt_root=)`` rolls back
through ``restore``; the backed-off lr reaches the graphs through the
lrs written before each replay.

``remat=`` (``"full"``, ``"dots"``, ``"dots_no_batch"`` or a PyTorch
selective-checkpoint policy) checkpoints the differentiated function,
the cast, the forward and the loss, as the reference's
``jax.checkpoint`` does (:mod:`._remat`): the backward runs the forward
again for what the policy did not save, with the first forward's
dropout bits and without a second BatchNorm fold, so a step is
bit-equal to the ``remat=None`` step; in ``step()``'s graph and in
``run_steps`` windows alike.

Not ported yet: multi-device meshes, ``rebuild_mesh``, per-shard
checkpoint writing and sharded ``param_rules`` are Queue 1 item 9; on
one device every spec projects to replication, so ``param_rules`` is
accepted and changes nothing.
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

from .. import _dispatch
from .. import autograd as _autograd
from ..base import MXNetError, as_torch_dtype, dtype_name
from ..gluon import cached_graph as _cg
from ..guardrails import fused as _guard
from ..guardrails.monitor import AnomalyMonitor, GuardConfig
from ..guardrails.trainer_mixin import GuardedTrainerMixin
from ..observability import instrument as _obs
from ..ops import optimizer_op as _ops
from . import _ckpt, _remat
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
def _lr_at(optimizer, t):
    """The lr one update at step ``t`` sees: the scheduler's, else the
    optimizer's. One rule for ``step`` and ``run_steps``."""
    if optimizer.lr_scheduler is not None:
        return float(optimizer.lr_scheduler(t))
    return float(optimizer.learning_rate)


def _lr_sequence(optimizer, t, num_steps):
    """The lrs of steps ``t .. t + num_steps - 1``, evaluated on the host:
    each inner step of a window sees the lr a separate ``step()`` would."""
    return [_lr_at(optimizer, t + i) for i in range(num_steps)]


class _Powers:
    """Device scalars of one step's ``t`` that every weight's rule reads
    (``beta ** t``, Nadam's schedule terms), computed once per step: each
    is the value each weight's rule would compute. For BERT-base's 155
    LAMB weights this spares 620 kernels, 1.4 ms of a 17.6 ms update per
    step on an H100 (PERF.md §6)."""

    def __init__(self, t):
        self.t = t
        self._memo = {}

    def get(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn(self.t)
        return self._memo[key]

    def power(self, base):
        return self.get(("pow", base), lambda t: base ** t)

    def one_minus_power(self, base):
        return self.get(("1-pow", base), lambda t: 1 - self.power(base))


def _opt_init_state(opt, w):
    """The optimizer state of weight ``w`` (ref:
    ``mxnet_tpu/parallel/sharded.py`` ``_opt_init_state``): zeros in
    ``w``'s dtype; Nadam adds its schedule product, an fp32 scalar one;
    DCASGD keeps a copy of the weight."""
    name = type(opt).__name__
    zeros = torch.zeros_like
    if name in ("SGD", "NAG", "Signum"):
        return (zeros(w),) if getattr(opt, "momentum", 0.0) != 0.0 else ()
    if name in ("Adam", "AdamW", "LAMB", "FTRL", "AdaDelta", "Nadam"):
        state = (zeros(w), zeros(w))
        if name == "Nadam":
            state += (torch.ones((), dtype=torch.float32, device=w.device),)
        return state
    if name in ("RMSProp", "AdaGrad"):
        return (zeros(w),)
    if name == "DCASGD":
        prev = w.detach().clone()
        if getattr(opt, "momentum", 0.0) != 0.0:
            return (zeros(w), prev)
        return (prev,)
    if name == "FTML":
        return (zeros(w), zeros(w), zeros(w))
    if name == "SGLD":
        return ()
    raise MXNetError(
        f"ShardedTrainer has no functional rule for optimizer "
        f"{name!r}; use the eager gluon.Trainer for it")


def _check_rule(opt):
    """SGLD has a state rule and no update rule, as in the reference."""
    if type(opt).__name__ == "SGLD":
        raise MXNetError("no functional update for SGLD")


def _opt_apply(opt, w, g, state, lr, pw, wd, rescale, clip):
    """One weight's update, out of place: ``(new_w, new_state)`` (ref:
    ``mxnet_tpu/parallel/sharded.py`` ``_opt_apply``). ``lr`` (the
    weight's, its multiplier in) and ``rescale`` are 0-d fp32 tensors;
    ``pw`` the step's :class:`_Powers`; ``wd`` and ``clip`` numbers.

    Nadam keeps its schedule product per weight, in the state, where the
    eager rule keeps one per optimizer; the reference's two rules differ
    the same way."""
    name = type(opt).__name__
    kw = dict(lr=lr, wd=wd, rescale_grad=rescale, clip_gradient=clip)
    if name in ("SGD", "NAG"):
        if not state:
            return _ops._sgd_update(w, g, **kw), ()
        fn = _ops._sgd_mom_update if name == "SGD" else _ops._nag_mom_update
        w2, m2 = fn(w, g, state[0], momentum=opt.momentum, **kw)
        return w2, (m2,)
    if name in ("Adam", "AdamW"):
        corr = pw.get(("adam", opt.beta1, opt.beta2), lambda t: torch.sqrt(
            1 - opt.beta2 ** t) / (1 - opt.beta1 ** t))
        fn = _ops._adam_update if name == "Adam" else _ops._adamw_update
        w2, m2, v2 = fn(w, g, state[0], state[1], beta1=opt.beta1,
                        beta2=opt.beta2, epsilon=opt.epsilon,
                        **dict(kw, lr=lr * corr))
        return w2, (m2, v2)
    if name == "LAMB":
        gp, m2, v2 = _ops._lamb_phase1(
            w, g, state[0], state[1], beta1=opt.beta1, beta2=opt.beta2,
            epsilon=opt.epsilon, bias_correction=opt.bias_correction,
            wd=wd, rescale_grad=rescale, clip_gradient=clip,
            corrections=(pw.one_minus_power(opt.beta1),
                         pw.one_minus_power(opt.beta2))
            if opt.bias_correction else None)
        r1 = torch.linalg.vector_norm(w, dtype=torch.float32)
        r2 = torch.linalg.vector_norm(gp)
        w2 = _ops._lamb_phase2(
            w, gp, r1, r2, lr=lr,
            lower_bound=opt.lower_bound if opt.lower_bound else -1.0,
            upper_bound=opt.upper_bound if opt.upper_bound else -1.0)
        return w2, (m2, v2)
    if name == "RMSProp":
        w2, n2 = _ops._rmsprop_update(w, g, state[0], gamma1=opt.gamma1,
                                      epsilon=opt.epsilon, **kw)
        return w2, (n2,)
    if name == "AdaGrad":
        w2, h2 = _ops._adagrad_update(w, g, state[0],
                                      epsilon=opt.float_stable_eps, **kw)
        return w2, (h2,)
    if name == "FTRL":
        w2, z2, n2 = _ops._ftrl_update(w, g, state[0], state[1],
                                       lamda1=opt.lamda1, beta=opt.beta, **kw)
        return w2, (z2, n2)
    if name == "Signum":
        if not state:
            return _ops._signsgd_update(w, g, **kw), ()
        g32 = _rescaled(g, rescale, clip)
        m2 = state[0] * opt.momentum - g32 * (1 - opt.momentum)
        w2 = w * (1 - lr * opt.wd_lh) + torch.sign(m2) * lr
        return w2.to(w.dtype), (m2,)
    if name == "AdaDelta":
        acc_g, acc_d = state
        gg = _rescaled(g, rescale, clip) + wd * w.float()
        acc_g2 = opt.rho * acc_g + (1 - opt.rho) * gg * gg
        delta = torch.sqrt(acc_d + opt.epsilon) / \
            torch.sqrt(acc_g2 + opt.epsilon) * gg
        acc_d2 = opt.rho * acc_d + (1 - opt.rho) * delta * delta
        return (w.float() - delta).to(w.dtype), (acc_g2, acc_d2)
    if name == "Nadam":
        return _nadam(opt, w, g, state, lr, pw, wd, rescale, clip)
    if name == "DCASGD":
        gg = _rescaled(g, rescale, clip)
        prev = state[-1]
        w32 = w.float()
        comp = gg + wd * w32 + opt.lamda * gg * gg * (w32 - prev)
        if len(state) == 1:
            return (w32 - lr * comp).to(w.dtype), (w32,)
        m2 = opt.momentum * state[0] - lr * comp
        return (w32 + m2).to(w.dtype), (m2, w32)
    if name == "FTML":
        dst, vst, zst = state
        gg = _rescaled(g, rescale, clip) + wd * w.float()
        v2 = opt.beta2 * vst + (1 - opt.beta2) * gg * gg
        d2 = pw.one_minus_power(opt.beta1) / lr * (
            torch.sqrt(v2 / pw.one_minus_power(opt.beta2)) + opt.epsilon)
        sigma = d2 - opt.beta1 * dst
        z2 = opt.beta1 * zst + (1 - opt.beta1) * gg - sigma * w.float()
        return (-z2 / d2).to(w.dtype), (d2, v2, z2)
    raise MXNetError(f"no functional update for {name}")


def _rescaled(g, rescale, clip):
    """``rescale * g`` in fp32, clipped when ``clip > 0``."""
    g32 = g.float() * rescale
    return torch.clamp(g32, -clip, clip) if clip > 0 else g32


def _nadam(opt, w, g, state, lr, pw, wd, rescale, clip):
    mean, var, msched = state
    gg = _rescaled(g, rescale, clip) + wd * w.float()
    d = opt.schedule_decay
    mom_t, mom_t1 = pw.get(("nadam", opt.beta1, d), lambda t: (
        opt.beta1 * (1 - 0.5 * 0.96 ** (t * d)),
        opt.beta1 * (1 - 0.5 * 0.96 ** ((t + 1) * d))))
    msched2 = msched * mom_t
    msched_next = msched2 * mom_t1
    m2 = opt.beta1 * mean + (1 - opt.beta1) * gg
    v2 = opt.beta2 * var + (1 - opt.beta2) * gg * gg
    g_p = gg / (1 - msched2)
    m_p = m2 / (1 - msched_next)
    v_p = v2 / pw.one_minus_power(opt.beta2)
    m_bar = (1 - mom_t) * g_p + mom_t1 * m_p
    w2 = w.float() - lr * m_bar / (torch.sqrt(v_p) + opt.epsilon)
    return w2.to(w.dtype), (m2, v2, msched2)


def _lr_mult(opt, index):
    """Weight ``index``'s lr multiplier, looked up as ``_get_lr`` does.
    The reference divides ``_get_lr(index)`` by ``learning_rate`` at the
    first step, which is the same number unless the lr is 0 then (a
    warm-up from 0): there the reference's quotient is 0 and every lr of
    the trainer stays 0; the port keeps the multiplier."""
    return opt._mult(index, "lr_mult", opt.lr_mult)


class ShardedTrainer(GuardedTrainerMixin):
    """Gluon-level front end of the one-program training step (ref: the JAX
    package's ``parallel.ShardedTrainer``)::

        mesh = parallel.make_mesh({"data": 1, "model": 1})
        trainer = parallel.ShardedTrainer(net, loss_fn, "sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            mesh=mesh, compute_dtype="bfloat16")
        loss = trainer.step(x, y)      # one CUDA graph replay on the card
        loss = trainer.run_steps(x, y, num_steps=8)   # one replay, 8 steps

    ``step(*batch)`` takes the model's inputs and, last, the label, as
    numpy arrays or tensors (float64 and int64 arrays become float32 and
    int32, as the JAX package's default types), and returns the mean
    loss as a 0-d tensor on the device; ``last_outputs`` holds the
    model's outputs. The parameters' ``.grad`` is not touched.

    The optimizer's lr and wd multipliers are read by trainable index
    (the order of the block's trainable parameters) at the first step:
    give them through the optimizer's ``param_dict`` or
    ``set_lr_mult`` / ``set_wd_mult``. A tensor's ``wd_mult`` attribute
    alone does not reach this trainer, as in the reference.

    ``guard=`` (``True`` or a ``GuardConfig``) makes every step guarded:
    a non-finite step leaves weights, optimizer state and BatchNorm
    statistics bit-unchanged; in ``mode="step"`` each step's (flag,
    loss, norm) is read once and fed to the ``AnomalyMonitor``, which
    journals skips and raises ``TrainingDiverged`` when its budget is
    spent; ``mode="deferred"`` reads nothing per step (``guard_poll``).
    ``clip_norm`` clips the global gradient norm inside the step.
    """

    _guard_consumer = "sharded_trainer"

    def __init__(self, block, loss_fn, optimizer, optimizer_params=None,
                 mesh=None, param_rules=None, *, compute_dtype=None,
                 remat=None, master_dtype=None, guard=None):
        from .. import optimizer as opt_mod
        self._remat_policy = _remat.resolve_policy(remat)
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
        self._num_update = self._optimizer.begin_num_update
        self._hyper = None                 # (wds, lr multipliers)
        self._guard_cfg = GuardConfig.coerce(guard)
        self._monitor = (AnomalyMonitor(self._guard_cfg,
                                        consumer=self._guard_consumer)
                         if self._guard_cfg is not None else None)
        self._scaler = None
        self._resolve_scaler()
        self._guard_state = None
        self._skipped_offset = 0
        self._backend = _cg.CudaGraphs()   # captures on the card
        self._programs = {}                # (steps, signature) -> Program
        self._amp_epoch = _dispatch.amp_epoch()
        self._eager_keys = set()           # signatures run eagerly (CPU)
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
        self._validate_guard_mode()

    def _guarded(self):
        """A guarded step is a bitwise no-op on a non-finite gradient;
        with neither a scaler nor a guard the update always applies, as
        an unwatched skip would freeze training unseen."""
        return self._scaler is not None or self._guard_cfg is not None

    def _reinit_guard_state(self):
        return _guard.init_guard_state(self.device)

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
        self._guard_state = self._reinit_guard_state()
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
        running a step (the resume entry point: prepare, then
        ``load_checkpoint`` or ``restore``)."""
        self._prepare(example_args)

    def _begin(self, batch):
        """Everything a step or a window needs before its scalars."""
        self._prepare(batch[:-1])
        if self._structure != _cg._structure[0]:
            self._check_params()
        self._resolve_scaler()
        _check_rule(self._optimizer)
        if self._hyper is None:
            # per-index wd and lr multipliers, read once as the
            # reference's program reads them when it is built
            opt, n = self._optimizer, len(self._trainable)
            self._hyper = ([opt._get_wd(i) for i in range(n)],
                           [_lr_mult(opt, i) for i in range(n)])

    # -- the step ------------------------------------------------------------
    def _loss_and_grads(self, inputs, label, lscale=1.0):
        """The differentiated half of the step on device tensors: the
        trainable parameters and floating inputs cast to the compute
        dtype, the forward in training mode, the loss, and
        ``torch.autograd.grad`` of ``mean(loss) * lscale`` into the
        trainable parameters (zeros where the loss does not reach).
        Returns (mean loss, gradients, model outputs). Under ``remat`` the
        cast, the forward and the loss run checkpointed."""
        block, loss_fn, cdt = self._block, self._loss, self._compute_dtype

        def loss_of(*_trainable):
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
            return torch.mean(per_sample.float()), outs

        with _autograd.record():
            if self._remat_policy is None:
                (loss, outs), queued = loss_of(), ()
            else:
                # the masters as the checkpoint's inputs: its device
                (loss, outs), queued = _remat.run(
                    loss_of, self._remat_policy, *self._trainable)
        grads = torch.autograd.grad(loss * lscale, self._trainable,
                                    allow_unused=True)
        with torch.no_grad():
            for update, args in queued:      # BatchNorm's folds, once
                update(*args)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._trainable, grads)]
        return loss.detach(), grads, [o.detach() for o in outs]

    def _update(self, grads, lr, t, rescale, finite):
        """Every trainable weight's update, in place: weight ``i`` takes
        ``lr`` times its multiplier and its wd; a guarded update keeps
        the old weight and state where ``finite`` is false."""
        opt = self._optimizer
        guarded = self._guarded()
        wds, mults = self._hyper
        clip = opt.clip_gradient if opt.clip_gradient is not None else -1.0
        pw = _Powers(t)
        for i, (w, g, s) in enumerate(zip(self._trainable, grads,
                                          self._states)):
            lr_i = lr if mults[i] == 1.0 else lr * mults[i]
            w2, s2 = _opt_apply(opt, w, g, s, lr_i, pw, wds[i], rescale,
                                clip)
            if guarded:
                w2 = torch.where(finite, w2, w)
                s2 = _guard.select(finite, s2, s)
            # the state first: DCASGD's new state is the old weight,
            # which w.float() gives without a copy for an fp32 weight
            for a, b in zip(s, s2):
                a.copy_(b)
            w.copy_(w2)

    def _body(self, inputs, label, lr, t, rescale, lscale):
        """One training step on device tensors, in place; ``lr``, ``t``,
        ``rescale`` and ``lscale`` 0-d fp32 tensors. Returns [loss,
        finite, global norm, *model outputs]."""
        guarded = self._guarded()
        with torch.no_grad():
            saved = [a.clone() for a in self._aux] if guarded else None
        loss, grads, outs = self._loss_and_grads(inputs, label, lscale)
        with torch.no_grad():
            inv = 1.0 / lscale
            finite, gnorm = _guard.guard_stats(grads, loss)
            gnorm = gnorm * inv
            rescale_all = rescale * inv
            cfg = self._guard_cfg
            if cfg is not None and cfg.clip_norm is not None:
                # the global-norm clip folded into the rescale, off the
                # norm the guard has already taken
                rescale_all = rescale_all * _guard.clip_scale(
                    gnorm * rescale, cfg.clip_norm)
            self._update(grads, lr, t, rescale_all, finite)
            if guarded:
                for a, a0 in zip(self._aux, saved):
                    a.copy_(torch.where(finite, a, a0))
                for c, v in zip(self._guard_state, _guard.update_guard_state(
                        self._guard_state, finite)):
                    c.copy_(v)
        return [loss, finite, gnorm] + outs

    def _window(self, inputs, label, scalars, n):
        """``n`` steps on one batch; ``scalars`` the (n + 3,) fp32 tensor
        (n lrs, t of the first step, rescale_grad, loss scale). Returns
        [stats, *model outputs] for one step and [stats] for a window:
        ``stats`` holds each step's (loss, finite flag, global norm) as a
        row of fp32, (3,) for one step and (n, 3) for a window, so the
        host reads a step or a window with one copy."""
        lrs = scalars[:n]
        t, rescale, lscale = scalars[n:].unbind()
        rows = []
        for i in range(n):
            loss, finite, gnorm, *outs = self._body(
                inputs, label, lrs[i], t + i if i else t, rescale, lscale)
            rows.append(torch.stack([loss, finite.float(), gnorm]))
        if n == 1:
            return [rows[0]] + outs
        return [torch.stack(rows)]

    def _scalar_tensor(self, lrs, t, rescale, lscale):
        return torch.tensor([*lrs, t, rescale, lscale], dtype=torch.float32)

    def _run(self, batch, lrs, t, site, **attrs):
        """``len(lrs)`` steps from step ``t``: a graph replay on the card,
        eager on the CPU. The ``data_wait`` and ``compiled_step`` phases
        are timed here, on the host: ``compiled_step`` wraps the replay
        (the Python of a captured function runs at capture only), and a
        program build (``site``; the capture, or on the CPU the first
        eager run of a signature) is an ``xla_compile`` span inside it."""
        lscale = self._scaler.loss_scale if self._scaler is not None else 1.0
        scalars = self._scalar_tensor(lrs, t, self._optimizer.rescale_grad,
                                      lscale)
        backend, n = self._backend, len(lrs)
        graphed = backend is not None and backend.accepts(self.device)
        with _obs.step_phase("sharded_trainer", "data_wait"):
            xs = [self._host(b) if graphed else self._on_device(b)
                  for b in batch]
        if self._programs and self._amp_epoch != _dispatch.amp_epoch():
            # the per-op AMP policy changed: every program casts as the
            # old one did
            self._release()
        self._amp_epoch = _dispatch.amp_epoch()
        key = (n, tuple((tuple(x.shape), x.dtype) for x in xs + [scalars]),
               self._compute_dtype, self._scaler is not None,
               self._amp_epoch)
        prog = self._programs.get(key) if graphed else None
        if prog is not None and prog.stale(self._block):
            # a parameter or buffer was rebound (Block.cast, a reinit):
            # every program reads and updates the old storage
            self._release()
            prog = None
        compiling = prog is None if graphed else key not in self._eager_keys
        with _obs.step_phase("sharded_trainer", "compiled_step"), \
                _obs.maybe_compile_span(
                    compiling, site,
                    shapes=[list(x.shape) for x in xs] if compiling
                    else None, **attrs):
            if graphed:
                return self._graph_steps(xs + [scalars], key, prog, n)
            self._eager_keys.add(key)
            with _cg._inside():
                return self._window(xs[:-1], xs[-1],
                                    scalars.to(self.device,
                                               non_blocking=True), n)

    def _graph_steps(self, tensors, key, prog, n):
        if prog is None:
            prog = self._programs[key] = self._capture(tensors, n)
        prog.load(tensors)
        prog.replay_forward()
        return [o.clone() for o in prog.out]

    def _capture(self, tensors, n):
        """Warm up and capture ``n`` steps at the signature of ``tensors``
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

        def steps():
            with _cg._inside():
                return self._window(inputs, label, scalars, n)

        kept = list(block.parameters()) + [s for st in self._states
                                           for s in st] \
            + list(self._guard_state)
        pool = backend.new_pool(dev)
        with _cg._capture_lock, torch.inference_mode(False), \
                _cg._state_kept(block, kept) as warm:
            backend.warm_up(steps, dev)
            if dev.type == "cuda":
                # the warm-up's blocks back to the device: the capture's
                # private pool needs about as much again
                torch.cuda.empty_cache()
            prog.fwd, prog.out, prog.fwd_launches, prog.bits = _cg._record(
                backend, steps, pool, list(warm.states), dev)
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
        self._begin(batch)
        self._num_update += 1
        t = self._num_update
        self._optimizer.num_update = t
        with _obs.trace.span("sharded_trainer.step", step=t):
            stats, *outs = self._run(batch, [_lr_at(self._optimizer, t)],
                                     t, "sharded_trainer.step")
            self.last_outputs = outs
            with _obs.step_phase("sharded_trainer", "guard_fetch"):
                self._after_step(t, stats)
        return stats[0]

    def run_steps(self, *batch, num_steps=8):
        """``num_steps`` training steps on one batch as one program (ref:
        the JAX package's ``run_steps``, a ``lax.scan`` of the step):
        on the card one CUDA graph per (input signature, ``num_steps``)
        holding ``num_steps`` copies of the step, so a window costs one
        replay. Inner step ``i`` takes the lr ``step()`` would at its
        update count (``_lr_sequence``, written before each replay) and
        its own dropout bits; the loss scale is frozen for the window,
        and its per-step flags, losses and norms go to the scaler and
        the monitor after it. Returns the last step's loss."""
        self._begin(batch)
        t = self._num_update + 1
        self._num_update += num_steps
        self._optimizer.num_update = self._num_update
        with _obs.trace.span("sharded_trainer.run_steps", start_step=t,
                             num_steps=num_steps):
            stats = self._run(batch, _lr_sequence(self._optimizer, t,
                                                  num_steps), t,
                              "sharded_trainer.run_steps",
                              num_steps=num_steps)[0]
            stats = stats.reshape(num_steps, 3)  # one step: step()'s program
            with _obs.step_phase("sharded_trainer", "guard_fetch"):
                self._after_run_steps(t, stats)
        return stats[-1, 0]

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
    def num_update(self):
        """Completed optimizer updates."""
        return self._num_update

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- checkpoint / resume --------------------------------------------------
    # The reference's files (ref: python/mxnet/gluon/trainer.py
    # save_states/load_states, python/mxnet/model.py save_checkpoint):
    # one .params container per file with a JSON __meta__ entry, weights
    # and state in their storage dtype, the dropout generator's state in
    # the meta, so a resume goes on bit for bit.

    def _require_prepared(self, what):
        if not self._prepared:
            raise MXNetError(
                f"ShardedTrainer.{what} needs the sharded state: call "
                "prepare(*example_args) or run a step first")

    def _struct_name(self, tensor):
        """Structural key ('features.0.weight') of a parameter or buffer,
        independent of the instance, as ``Block.save_parameters`` keys
        it; the first name of a tensor shared under several."""
        by_id = self.__dict__.get("_struct_cache")
        if by_id is None:
            by_id = {}
            for key, t in self._block.collect_params().items():
                by_id.setdefault(id(t), key)
            self._struct_cache = by_id
        return by_id[id(tensor)]

    def _state_entries(self):
        """name -> live tensor of every optimizer-state leaf."""
        return {f"state:{self._struct_name(p)}:{j}": s
                for p, st in zip(self._trainable, self._states)
                for j, s in enumerate(st)}

    def _param_entries(self):
        out = {f"arg:{self._struct_name(p)}": p for p in self._trainable}
        out.update((f"aux:{self._struct_name(t)}", t) for t in self._aux)
        return out

    def _ckpt_meta(self, per_shard):
        meta = {
            "format": _ckpt.CKPT_FORMAT,
            "optimizer": type(self._optimizer).__name__,
            "num_update": int(self._num_update),
            "master_dtype": (dtype_name(self._master_dtype)
                             if self._master_dtype is not None else None),
            "state_arity": [len(st) for st in self._states],
            "per_shard": bool(per_shard),
            "shard_files": _ckpt.group().count(),
        }
        meta.update(_ckpt.rng_meta(self.device))
        return meta

    def _entries_of(self, fname, meta, loaded, live):
        """(live tensor, checked host tensor) for every name of ``live``,
        from a full file or from its per-shard pieces."""
        pieces = None
        if meta["per_shard"]:
            pieces = _ckpt.read_pieces(
                fname, int(meta.get("shard_files", 1)), set(live))
        return [(cur, _ckpt.place_like(name, cur, loaded, pieces))
                for name, cur in live.items()]

    def _adopt(self, pairs, meta, source):
        """Copy the checked tensors into the live ones in place (the
        captured programs keep reading the same addresses), then take the
        meta's update count and dropout generator state."""
        _ckpt.copy_into(pairs)
        self._num_update = int(meta["num_update"])
        self._optimizer.num_update = self._num_update
        _ckpt.restore_rng(meta, self.device, source)

    def save_states(self, fname, per_shard=None):
        """Write the optimizer state, the update count and the dropout
        generator's state to ``fname`` (ref: gluon.Trainer.save_states).
        One file: per-shard writing is ROADMAP Queue 1 item 9."""
        self._require_prepared("save_states")
        _ckpt.write_entries(fname, self._state_entries(),
                            self._ckpt_meta(bool(per_shard)))

    def _check_states_meta(self, meta):
        """The contract of a ``.states`` meta: optimizer class, master
        storage dtype and state arity (the reference's messages)."""
        if meta["optimizer"] != type(self._optimizer).__name__:
            raise MXNetError(
                f"checkpoint was saved with optimizer {meta['optimizer']!r}, "
                f"trainer has {type(self._optimizer).__name__!r}")
        want_mdt = (dtype_name(self._master_dtype)
                    if self._master_dtype is not None else None)
        if meta.get("master_dtype") != want_mdt:
            raise MXNetError(
                f"checkpoint was saved with master_dtype="
                f"{meta.get('master_dtype')!r}, trainer has {want_mdt!r} — "
                "resume with the same storage dtype (a cast would change "
                "the training trajectory)")
        if meta["state_arity"] != [len(st) for st in self._states]:
            raise MXNetError("checkpoint state arity mismatch — different "
                             "optimizer config or parameter set")

    def _states_pairs(self, fname):
        meta, loaded = _ckpt.read_meta(fname)
        self._check_states_meta(meta)
        return meta, self._entries_of(fname, meta, loaded,
                                      self._state_entries())

    def load_states(self, fname):
        """Restore what ``save_states`` wrote, in place. The trainer must
        be prepared with the same architecture, optimizer class and
        master_dtype."""
        self._require_prepared("load_states")
        meta, pairs = self._states_pairs(fname)
        self._adopt(pairs, meta, fname)

    def save_checkpoint(self, prefix, per_shard=None):
        """The full snapshot: ``<prefix>.params`` (master weights and
        auxiliary state in their storage dtype) and ``<prefix>.states``
        (ref: the mx.model checkpoint pair)."""
        self._require_prepared("save_checkpoint")
        _ckpt.write_entries(f"{prefix}.params", self._param_entries(),
                            self._ckpt_meta(bool(per_shard)))
        self.save_states(f"{prefix}.states", per_shard=per_shard)

    def load_checkpoint(self, prefix):
        """Resume from ``save_checkpoint``'s pair onto a prepared trainer,
        bit for bit: every entry is checked before any is copied."""
        self._require_prepared("load_checkpoint")
        fname = f"{prefix}.params"
        meta, loaded = _ckpt.read_meta(fname)
        pairs = self._entries_of(fname, meta, loaded, self._param_entries())
        smeta, spairs = self._states_pairs(f"{prefix}.states")
        self._adopt(pairs + spairs, smeta, prefix)

    def checkpoint(self, ckpt_dir, step=None, keep_last=None,
                   per_shard=None):
        """Crash-consistent directory checkpoint (the commit protocol):
        the pair staged under ``<ckpt_dir>/step-N.tmp/``, committed behind
        a CRC manifest and a rename, the ``latest`` pointer moved, the
        last ``keep_last`` steps kept. ``step`` defaults to the update
        count. Returns the committed step."""
        self._require_prepared("checkpoint")
        step = int(self._num_update if step is None else step)
        return _ckpt.commit_checkpoint(
            ckpt_dir, step,
            lambda prefix: self.save_checkpoint(prefix, per_shard=per_shard),
            keep_last=keep_last)

    def restore(self, ckpt_dir, step=None, latest=True):
        """Resume from the newest valid committed step under ``ckpt_dir``
        (or a pinned ``step``): a corrupt or torn newer step is skipped
        with a journaled ``ckpt_fallback``. Returns the restored step."""
        self._require_prepared("restore")
        if step is None and not latest:
            raise MXNetError("restore needs step=N or latest=True")
        return _ckpt.restore_checkpoint(ckpt_dir, self.load_checkpoint,
                                        step=step)

    def load_checkpoint_resharded(self, prefix):
        """:meth:`load_checkpoint` for a pair any number of processes
        wrote, full-file or per-shard: the pieces are assembled into full
        tensors (coverage proven) and copied in, bit for bit."""
        self._require_prepared("load_checkpoint_resharded")
        from ..elastic import reshard as _reshard
        meta, entries = _reshard.read_global_entries(f"{prefix}.params")
        smeta, sentries = _reshard.read_global_entries(f"{prefix}.states")
        self._check_states_meta(smeta)
        pairs = []
        for name, cur in {**self._param_entries(),
                          **self._state_entries()}.items():
            src = sentries if name.startswith("state:") else entries
            if name not in src:
                raise MXNetError(f"checkpoint is missing entry {name!r}")
            pairs.append((cur, _reshard.place_global(name, cur, src[name])))
        self._adopt(pairs, smeta, prefix)
        _reshard.journal_reshard(prefix, self._num_update, meta,
                                 _ckpt.group().count(),
                                 {**entries, **sentries},
                                 self._guard_consumer)

    def restore_resharded(self, ckpt_dir, step=None):
        """:meth:`restore` through :meth:`load_checkpoint_resharded`:
        whatever topology wrote the step. Returns the restored step."""
        self._require_prepared("restore_resharded")
        return _ckpt.restore_checkpoint(
            ckpt_dir, self.load_checkpoint_resharded, step=step)

    def rebuild_mesh(self, mesh):
        raise MXNetError("ShardedTrainer.rebuild_mesh is not ported yet: it "
                         "needs meshes of more than one device (ROADMAP "
                         "Queue 1 item 9)")
