"""Optimizer classes (counterpart of ``mxnet_tpu/optimizer/optimizer.py``,
ref ``python/mxnet/optimizer/optimizer.py``).

An :class:`Optimizer` holds the hyperparameters, an lr scheduler, the
per-parameter lr and wd multipliers and a per-index update count,
creates each weight's state and calls the fused updates of
:mod:`mxnet_tpu_torch.ops.optimizer_op` (or, for the rules the JAX
package writes as NDArray arithmetic, the same arithmetic on tensors),
which write weight and state in place. An :class:`Updater` keeps the
states keyed by weight index. With ``multi_precision`` a low-precision
weight keeps an fp32 master copy in its state, updated in its place.

The multipliers of weight ``index`` come, in this order, from
``param_dict[index]`` (a tensor's ``lr_mult`` / ``wd_mult`` attributes,
which ``gluon.Trainer`` passes in), from ``set_lr_mult`` /
``set_wd_mult`` keyed by index, or from those keyed by the name that
``param_idx2name`` gives the index.
"""
from __future__ import annotations

import math
import pickle

import torch

from .. import random as _random
from ..base import MXNetError
from ..ops import optimizer_op as _op

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "LAMB", "RMSProp",
           "AdaGrad", "FTRL", "Signum", "SGLD", "AdaDelta", "Nadam",
           "DCASGD", "FTML", "Updater", "create", "register", "get_updater"]

_REGISTRY = {}


def register(klass):
    """Register an Optimizer subclass under its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An :class:`Optimizer` from an instance or a registered name."""
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


def _clip(g, clip_gradient):
    return torch.clamp(g, -clip_gradient, clip_gradient)


def _sgld_noise(weight, lr):
    """Normal(0, sqrt(lr)) noise of ``weight``'s shape and dtype, from
    the ``mx.random`` generator of its device."""
    return torch.normal(0.0, math.sqrt(lr), tuple(weight.shape),
                        generator=_random.device_generator(weight.device),
                        dtype=weight.dtype, device=weight.device)


class _Multipliers:
    """A weight's ``lr_mult`` and ``wd_mult``, as a pickled optimizer's
    ``param_dict`` carries them in place of the live tensor."""

    def __init__(self, tensor):
        for attr in ("lr_mult", "wd_mult"):
            if hasattr(tensor, attr):
                setattr(self, attr, getattr(tensor, attr))


class Optimizer:
    """ref: optimizer.py Optimizer — lr (or an lr scheduler), wd, lr and
    wd multipliers per weight, ``rescale_grad``, ``clip_gradient`` and
    per-index update counts that start at ``begin_num_update``."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    def __getstate__(self):
        """A pickle carries the hyperparameters, counts, scheduler and
        multipliers, and no tensor: ``param_dict`` goes as each weight's
        multipliers (the trainer gives a restored optimizer its live
        tensors back)."""
        state = dict(self.__dict__)
        state["param_dict"] = {i: _Multipliers(t)
                               for i, t in self.param_dict.items()}
        return state

    # -- state ---------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """The state, and with ``multi_precision`` and a weight that is
        not fp32, ``(state of the fp32 master, master)``."""
        if self.multi_precision and weight.dtype != torch.float32:
            master = weight.detach().float()
            return (self.create_state(index, master), master)
        return self.create_state(index, weight)

    # -- bookkeeping ---------------------------------------------------------
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr, table):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        """The lr of weight ``index``: the scheduler's at ``num_update``
        (else ``lr``) times its lr multiplier."""
        lr = (self.lr_scheduler(self.num_update) if self.lr_scheduler
              else self.lr)
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        """The wd of weight ``index``: ``wd`` times its wd multiplier."""
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set lr directly when lr_scheduler is "
                             "set")
        self.lr = lr

    @property
    def learning_rate(self):
        return (self.lr_scheduler(self.num_update) if self.lr_scheduler
                else self.lr)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _common(self, index):
        return dict(lr=self._get_lr(index), wd=self._get_wd(index),
                    rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient
                    if self.clip_gradient is not None else -1.0)

    # -- update --------------------------------------------------------------
    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_row_sparse(self, index, weight, grad, state):
        """This optimizer's own rule on the touched rows alone of a sparse
        COO gradient (``grad.is_sparse``, coalesced; ref: the lazy
        row_sparse paths of src/operator/optimizer_op.cc): the weight's
        and the state's rows are gathered, :meth:`update` runs on them,
        and they are written back. Untouched rows see no weight decay and
        no state decay; the rows stay on the weight's device."""
        rows = grad.indices()[0]
        w_rows = weight.detach()[rows]
        state_rows = _map_state(state, lambda s: s[rows])
        self.update(index, w_rows, grad.values().to(weight.dtype),
                    state_rows)
        with torch.no_grad():
            weight.index_copy_(0, rows, w_rows)
            _zip_state(state, state_rows,
                       lambda s, r: s.index_copy_(0, rows, r))

    def update_multi_precision(self, index, weight, grad, state):
        """``update``, on the fp32 master when the state holds one (see
        :meth:`create_state_multi_precision`), the weight then the
        master cast to its dtype. A sparse gradient takes
        :meth:`update_row_sparse` and writes back only its rows."""
        if grad.is_sparse:
            grad = grad.coalesce()
            if self.multi_precision and weight.dtype != torch.float32:
                inner, master = state
                self.update_row_sparse(index, master, grad.float(), inner)
                rows = grad.indices()[0]
                with torch.no_grad():
                    weight.index_copy_(0, rows,
                                       master[rows].to(weight.dtype))
            else:
                self.update_row_sparse(index, weight, grad, state)
            return
        if self.multi_precision and weight.dtype != torch.float32:
            inner, master = state
            self.update(index, master, grad.float(), inner)
            with torch.no_grad():
                weight.copy_(master.to(weight.dtype))
        else:
            self.update(index, weight, grad, state)


@register
class SGD(Optimizer):
    """SGD with optional momentum (ref: optimizer.py SGD →
    sgd_update / sgd_mom_update)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common(index)
        if state is None:
            _op.sgd_update(weight, grad, **kw)
        else:
            _op.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                               **kw)


@register
class NAG(Optimizer):
    """Nesterov SGD (ref: optimizer.py NAG → nag_mom_update)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common(index)
        if state is None:
            _op.sgd_update(weight, grad, **kw)
        else:
            _op.nag_mom_update(weight, grad, state, momentum=self.momentum,
                               **kw)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the learning rate,
    ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` (ref: optimizer.py Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def _corrected(self, index):
        self._update_count(index)
        kw = self._common(index)
        t = self._index_update_count[index]
        kw["lr"] *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1
                                                        ** t)
        return kw

    def update(self, index, weight, grad, state):
        kw = self._corrected(index)
        mean, var = state
        _op.adam_update(weight, grad, mean, var, beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon, **kw)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (ref: optimizer.py AdamW →
    adamw_update)."""

    def update(self, index, weight, grad, state):
        kw = self._corrected(index)
        mean, var = state
        _op.adamw_update(weight, grad, mean, var, beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon, **kw)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive large-batch optimizer: Adam's direction plus
    decoupled decay, scaled per weight by the trust ratio |w| / |g'|
    (ref: optimizer.py LAMB → lamb_update_phase1 / phase2)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common(index)
        t = self._index_update_count[index]
        mean, var = state
        g = _op.lamb_update_phase1(
            weight, grad, mean, var, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, t=t, bias_correction=self.bias_correction,
            wd=kw["wd"], rescale_grad=kw["rescale_grad"],
            clip_gradient=kw["clip_gradient"])
        r1 = torch.linalg.vector_norm(weight.detach())
        r2 = torch.linalg.vector_norm(g)
        _op.lamb_update_phase2(
            weight, g, r1, r2, lr=kw["lr"],
            lower_bound=self.lower_bound if self.lower_bound else -1.0,
            upper_bound=self.upper_bound if self.upper_bound else -1.0)


@register
class RMSProp(Optimizer):
    """RMSProp (ref: optimizer.py RMSProp → rmsprop_update; ``gamma2``
    and ``centered`` are kept and, as there, not used)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _op.rmsprop_update(weight, grad, state, gamma1=self.gamma1,
                           epsilon=self.epsilon, **self._common(index))


@register
class AdaGrad(Optimizer):
    """AdaGrad (ref: optimizer.py AdaGrad → adagrad_update)."""

    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _op.adagrad_update(weight, grad, state, epsilon=self.float_stable_eps,
                           **self._common(index))


@register
class FTRL(Optimizer):
    """FTRL-proximal (ref: optimizer.py FTRL → ftrl_update)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        _op.ftrl_update(weight, grad, z, n, lamda1=self.lamda1,
                        beta=self.beta, **self._common(index))


@register
class Signum(Optimizer):
    """signSGD with momentum (ref: optimizer.py Signum). With momentum,
    ``m = momentum * m - (1 - momentum) * g`` and ``w = w * (1 - lr *
    wd_lh) + lr * sign(m)``, in the weight's dtype; ``wd`` does not
    enter that branch, as in the reference."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common(index)
        if state is None:
            _op.signsgd_update(weight, grad, **kw)
            return
        g = grad * self.rescale_grad
        if kw["clip_gradient"] > 0:
            g = _clip(g, kw["clip_gradient"])
        state.copy_(state * self.momentum - g * (1 - self.momentum))
        weight.copy_(weight * (1 - kw["lr"] * self.wd_lh)
                     + torch.sign(state) * kw["lr"])


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (ref: optimizer.py SGLD):
    ``w -= lr / 2 * (g + wd * w)`` plus Normal(0, sqrt(lr)) noise, drawn
    from the weight device's ``mx.random`` generator (seeded by
    ``mx.random.seed``)."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common(index)
        g = grad * self.rescale_grad
        if kw["clip_gradient"] > 0:
            g = _clip(g, kw["clip_gradient"])
        weight.copy_(weight - kw["lr"] / 2 * (g + kw["wd"] * weight)
                     + _sgld_noise(weight, kw["lr"]))


@register
class AdaDelta(Optimizer):
    """AdaDelta, which takes no learning rate (ref: optimizer.py
    AdaDelta), in the weight's dtype."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = _clip(g, self.clip_gradient)
        g = g + wd * weight
        acc_g, acc_delta = state
        acc_g_new = self.rho * acc_g + (1.0 - self.rho) * g * g
        delta = torch.sqrt(acc_delta + self.epsilon) / \
            torch.sqrt(acc_g_new + self.epsilon) * g
        acc_delta_new = self.rho * acc_delta + (1.0 - self.rho) * delta \
            * delta
        acc_g.copy_(acc_g_new)
        acc_delta.copy_(acc_delta_new)
        weight.copy_(weight - delta)


@register
class Nadam(Optimizer):
    """Adam with a Nesterov momentum schedule (ref: optimizer.py Nadam),
    in the weight's dtype. As in the reference, the schedule product
    ``m_schedule`` is the optimizer's and advances once per ``update``
    call, so once per weight per step; ``parallel.ShardedTrainer`` keeps
    one per weight instead, as the reference's functional rule does."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = _clip(g, self.clip_gradient)
        g = g + wd * weight
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        mean, var = state
        m_new = self.beta1 * mean + (1.0 - self.beta1) * g
        v_new = self.beta2 * var + (1.0 - self.beta2) * g * g
        g_prime = g / (1.0 - self.m_schedule)
        m_prime = m_new / (1.0 - m_schedule_next)
        v_prime = v_new / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        mean.copy_(m_new)
        var.copy_(v_new)
        weight.copy_(weight - lr * m_bar / (torch.sqrt(v_prime)
                                            + self.epsilon))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (ref: optimizer.py DCASGD): the
    state keeps a copy of the previous weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = torch.zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.detach().clone())

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = _clip(g, self.clip_gradient)
        mom, prev = state
        comp = g + wd * weight + self.lamda * g * g * (weight - prev)
        if mom is None:
            step = -lr * comp
        else:
            mom.copy_(self.momentum * mom - lr * comp)
            step = mom
        new = weight + step
        prev.copy_(weight)
        weight.copy_(new)


@register
class FTML(Optimizer):
    """Follow the Moving Leader (ref: optimizer.py FTML), in the weight's
    dtype."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(torch.zeros_like(weight) for _ in range(3))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = _clip(g, self.clip_gradient)
        g = g + wd * weight
        d, v, z = state
        v_new = self.beta2 * v + (1.0 - self.beta2) * g * g
        d_new = (1.0 - self.beta1 ** t) / lr * (
            torch.sqrt(v_new / (1.0 - self.beta2 ** t)) + self.epsilon)
        sigma = d_new - self.beta1 * d
        z_new = self.beta1 * z + (1.0 - self.beta1) * g - sigma * weight
        v.copy_(v_new)
        d.copy_(d_new)
        z.copy_(z_new)
        weight.copy_(-z_new / d_new)


class BF16Bits:
    """A bfloat16 state tensor in a pickle: its bits as a uint16 numpy
    array (numpy has no bfloat16 of its own), back bit for bit."""

    def __init__(self, tensor):
        self.bits = tensor.detach().cpu().view(torch.int16).numpy() \
            .view("uint16")

    def tensor(self):
        return torch.from_numpy(self.bits.view("int16").copy()) \
            .view(torch.bfloat16)


def _state_to_np(s):
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        return tuple(_state_to_np(x) for x in s)
    if s.dtype == torch.bfloat16:
        return BF16Bits(s)
    return s.detach().cpu().numpy()


def _state_from_np(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_state_from_np(x) for x in s)
    if isinstance(s, BF16Bits):
        return s.tensor()
    return torch.from_numpy(s.copy())


def _map_state(s, fn):
    """``fn`` over every tensor of a state (None, a tensor or a tuple)."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_map_state(x, fn) for x in s)
    return fn(s)


def _zip_state(dst, src, fn):
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _zip_state(d, s, fn)
    elif dst is not None:
        fn(dst, src)


def _same_layout(a, b):
    """Two states of the same structure, shapes and dtypes."""
    if a is None or b is None:
        return a is b
    if isinstance(a, tuple) or isinstance(b, tuple):
        return (isinstance(a, tuple) and isinstance(b, tuple)
                and len(a) == len(b)
                and all(_same_layout(x, y) for x, y in zip(a, b)))
    return a.shape == b.shape and a.dtype == b.dtype


def _copy_state(live, host):
    if isinstance(live, tuple):
        for a, b in zip(live, host):
            _copy_state(a, b)
    elif live is not None:
        live.copy_(host)


def _state_to(s, device):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_state_to(x, device) for x in s)
    return s.to(device)


class Updater:
    """The states of one optimizer keyed by weight index (ref:
    optimizer.py Updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self._to_place = set()      # restored states still on the host

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        elif self._to_place and index in self._to_place:
            self.states[index] = _state_to(self.states[index], weight.device)
            self._to_place.discard(index)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        """A pickle of the states as numpy arrays keyed by index (bfloat16
        ones as :class:`BF16Bits`), with the optimizer when
        ``dump_optimizer`` (ref: Updater.get_states)."""
        states_np = {k: _state_to_np(s) for k, s in self.states.items()}
        payload = (states_np, self.optimizer) if dump_optimizer else states_np
        return pickle.dumps(payload)

    def set_states(self, states):
        """Restore :meth:`get_states`' pickle (ref: Updater.set_states). A
        state that already exists with the same shapes and dtypes is
        copied into in place; a new one lives on the host until its
        weight's first update moves it to the weight's device. A pickled
        optimizer replaces this one and takes over its ``param_dict``
        (the live tensors), if it has one; else it keeps the multipliers
        it carries."""
        payload = pickle.loads(states)
        if isinstance(payload, tuple):
            states_np, optimizer = payload
            if self.optimizer.param_dict:
                optimizer.param_dict = self.optimizer.param_dict
            self.optimizer = optimizer
        else:
            states_np = payload
        new, to_place = {}, set()
        for k, v in states_np.items():
            host = _state_from_np(v)
            if k in self.states and _same_layout(self.states[k], host):
                with torch.no_grad():
                    _copy_state(self.states[k], host)
                new[k] = self.states[k]
            else:
                new[k] = host
                to_place.add(k)
        self.states, self._to_place = new, to_place


def get_updater(optimizer):
    return Updater(optimizer)
