"""Fused optimizer updates (counterpart of
``mxnet_tpu/ops/optimizer_op.py``, ref ``src/operator/optimizer_op.cc``).

Each update reads the gradient, rescales, clips and adds weight decay in
fp32 (:func:`_prep_grad`; AdamW and LAMB decouple the decay). The
out-of-place forms (``_sgd_update``, ``_adam_update``,
``_lamb_phase1``, ...) return the new weight and state, as the JAX ops
do, and take ``lr``, ``rescale_grad`` and LAMB's ``t`` as Python numbers
or 0-d tensors on the weight's device (a CUDA graph reads those where
they live, so a new lr or step replays the same graph). The public forms
write the new values into the given tensors in place under
``torch.no_grad()`` (the JAX package returns new arrays; the port saves
the copies). The arithmetic follows the JAX ops term for term, in fp32,
cast back to each tensor's dtype. The ``mp_`` forms keep an fp32 master
copy beside a low-precision weight.
"""
from __future__ import annotations

import torch

__all__ = ["adagrad_update", "adam_update", "adamw_update", "ftrl_update",
           "lamb_update_phase1", "lamb_update_phase2", "mp_sgd_mom_update",
           "mp_sgd_update", "nag_mom_update", "rmsprop_update",
           "sgd_mom_update", "sgd_update", "signsgd_update"]


def _prep_grad(weight, grad, rescale_grad, clip_gradient, wd=None):
    """``rescale_grad * grad``, clipped to ``[-clip, clip]`` when
    ``clip_gradient > 0``, plus ``wd * weight``; in fp32."""
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd:
        g = g + wd * weight.float()
    return g


def _sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    """The new weight ``weight - lr * (rescale * clip(grad) + wd *
    weight)``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient, wd)
    return (weight.float() - lr * g).to(weight.dtype)


def _sgd_mom_update(weight, grad, mom, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, momentum=0.0):
    """The new ``(weight, mom)``: ``mom = momentum * mom - lr * g``,
    ``weight += mom``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient, wd)
    mom_new = momentum * mom.float() - lr * g
    return (weight.float() + mom_new).to(weight.dtype), mom_new.to(mom.dtype)


def _adam_update(weight, grad, mean, var, lr, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """The new ``(weight, mean, var)`` of Adam without bias correction
    (the caller folds it into ``lr``)."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient, wd)
    mean_new = beta1 * mean.float() + (1 - beta1) * g
    var_new = beta2 * var.float() + (1 - beta2) * torch.square(g)
    w_new = weight.float() - lr * mean_new / (torch.sqrt(var_new) + epsilon)
    return (w_new.to(weight.dtype), mean_new.to(mean.dtype),
            var_new.to(var.dtype))


def _nag_mom_update(weight, grad, mom, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, momentum=0.0):
    """Nesterov momentum: ``mom = momentum * mom + g``, ``weight -= lr *
    (g + momentum * mom)``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient, wd)
    mom_new = momentum * mom.float() + g
    w_new = weight.float() - lr * (g + momentum * mom_new)
    return w_new.to(weight.dtype), mom_new.to(mom.dtype)


def _adamw_update(weight, grad, mean, var, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, beta1=0.9, beta2=0.999, epsilon=1e-8,
                  eta=1.0):
    """AdamW, the decay decoupled from the gradient: ``weight -= eta * lr
    * (mean / (sqrt(var) + epsilon) + wd * weight)``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient)
    mean_new = beta1 * mean.float() + (1 - beta1) * g
    var_new = beta2 * var.float() + (1 - beta2) * torch.square(g)
    w32 = weight.float()
    upd = mean_new / (torch.sqrt(var_new) + epsilon) + wd * w32
    w_new = w32 - eta * lr * upd
    return (w_new.to(weight.dtype), mean_new.to(mean.dtype),
            var_new.to(var.dtype))


def _lamb_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, corrections=None):
    """LAMB's first phase: ``(g', mean, var)`` with the fp32 direction
    ``g' = m_hat / (sqrt(v_hat) + epsilon) + wd * weight``.
    ``corrections`` is ``(1 - beta1 ** t, 1 - beta2 ** t)`` where the
    caller already has them (a step over many weights computes them
    once); otherwise they come from ``t``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient)
    mean_new = beta1 * mean.float() + (1 - beta1) * g
    var_new = beta2 * var.float() + (1 - beta2) * torch.square(g)
    m_hat, v_hat = mean_new, var_new
    if bias_correction:
        c1, c2 = corrections or (1 - beta1 ** t, 1 - beta2 ** t)
        m_hat = mean_new / c1
        v_hat = var_new / c2
    gp = m_hat / (torch.sqrt(v_hat) + epsilon) + wd * weight.float()
    return gp, mean_new.to(mean.dtype), var_new.to(var.dtype)


def _lamb_phase2(weight, g, r1, r2, lr, lower_bound=-1.0, upper_bound=-1.0):
    """LAMB's second phase: ``weight -= lr * ratio * g'`` with the trust
    ratio ``r1 / r2`` (``r1`` = |weight| clamped to the bounds given,
    ``r2`` = |g'|), 1 where either norm is 0."""
    if lower_bound > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                        torch.ones_like(r1))
    w_new = weight.float() - lr * ratio * g
    return w_new.to(weight.dtype)


def _rmsprop_update(weight, grad, n, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, gamma1=0.95, epsilon=1e-8):
    """RMSProp: ``n = gamma1 * n + (1 - gamma1) * g^2``, ``weight -= lr *
    g / (sqrt(n) + epsilon)``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient, wd)
    n_new = gamma1 * n.float() + (1 - gamma1) * torch.square(g)
    w_new = weight.float() - lr * g / (torch.sqrt(n_new) + epsilon)
    return w_new.to(weight.dtype), n_new.to(n.dtype)


def _ftrl_update(weight, grad, z, n, lr, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0, lamda1=0.01, beta=1.0):
    """FTRL-proximal: the new ``(weight, z, n)``; a weight is 0 where
    ``|z| <= lamda1``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient)
    n32, z32 = n.float(), z.float()
    n_new = n32 + torch.square(g)
    sigma = (torch.sqrt(n_new) - torch.sqrt(n32)) / lr
    z_new = z32 + g - sigma * weight.float()
    w_new = torch.where(
        torch.abs(z_new) <= lamda1, torch.zeros_like(z_new),
        -(z_new - torch.sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd))
    return (w_new.to(weight.dtype), z_new.to(z.dtype),
            n_new.to(n.dtype))


def _adagrad_update(weight, grad, history, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, epsilon=1e-7):
    """AdaGrad: ``history += g^2``, ``weight -= lr * g / (sqrt(history) +
    epsilon)``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient, wd)
    h_new = history.float() + torch.square(g)
    w_new = weight.float() - lr * g / (torch.sqrt(h_new) + epsilon)
    return w_new.to(weight.dtype), h_new.to(history.dtype)


def _signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    """signSGD: ``weight -= lr * sign(g)``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient, wd)
    return (weight.float() - lr * torch.sign(g)).to(weight.dtype)


def _mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """SGD on the fp32 master ``weight32`` of a low-precision weight: the
    new ``(weight, weight32)``."""
    g = _prep_grad(weight32, grad, rescale_grad, clip_gradient, wd)
    w32_new = weight32 - lr * g
    return w32_new.to(weight.dtype), w32_new


def _mp_sgd_mom_update(weight, grad, mom, weight32, lr, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0, momentum=0.0):
    """Momentum SGD on the fp32 master: the new ``(weight, mom,
    weight32)``."""
    g = _prep_grad(weight32, grad, rescale_grad, clip_gradient, wd)
    mom_new = momentum * mom - lr * g
    w32_new = weight32 + mom_new
    return w32_new.to(weight.dtype), mom_new, w32_new


def _write(targets, values):
    for t, v in zip(targets, values):
        t.copy_(v)


@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """``weight -= lr * (rescale * clip(grad) + wd * weight)``."""
    weight.copy_(_sgd_update(weight, grad, lr, wd, rescale_grad,
                             clip_gradient))


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, momentum=0.0):
    """Momentum SGD: ``mom = momentum * mom - lr * g``, ``weight +=
    mom``."""
    _write((weight, mom), _sgd_mom_update(weight, grad, mom, lr, wd,
                                          rescale_grad, clip_gradient,
                                          momentum))


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """Adam without bias correction (the Optimizer folds it into
    ``lr``): ``mean = beta1 mean + (1 - beta1) g``, ``var = beta2 var +
    (1 - beta2) g^2``, ``weight -= lr mean / (sqrt(var) + epsilon)``."""
    _write((weight, mean, var), _adam_update(
        weight, grad, mean, var, lr, wd, rescale_grad, clip_gradient, beta1,
        beta2, epsilon))


@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, momentum=0.0):
    """Nesterov momentum SGD, in place (see :func:`_nag_mom_update`)."""
    _write((weight, mom), _nag_mom_update(weight, grad, mom, lr, wd,
                                          rescale_grad, clip_gradient,
                                          momentum))


@torch.no_grad()
def adamw_update(weight, grad, mean, var, lr, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 eta=1.0):
    """AdamW, in place (see :func:`_adamw_update`)."""
    _write((weight, mean, var), _adamw_update(
        weight, grad, mean, var, lr, wd, rescale_grad, clip_gradient, beta1,
        beta2, epsilon, eta))


@torch.no_grad()
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's first phase: writes ``mean`` and ``var`` in place and
    returns the fp32 direction ``g'``."""
    gp, m, v = _lamb_phase1(weight, grad, mean, var, beta1, beta2, epsilon,
                            t, bias_correction, wd, rescale_grad,
                            clip_gradient)
    _write((mean, var), (m, v))
    return gp


@torch.no_grad()
def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """LAMB's second phase, in place (see :func:`_lamb_phase2`)."""
    weight.copy_(_lamb_phase2(weight, g, r1, r2, lr, lower_bound,
                              upper_bound))


@torch.no_grad()
def rmsprop_update(weight, grad, n, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, gamma1=0.95, epsilon=1e-8):
    """RMSProp, in place (see :func:`_rmsprop_update`)."""
    _write((weight, n), _rmsprop_update(weight, grad, n, lr, wd,
                                        rescale_grad, clip_gradient, gamma1,
                                        epsilon))


@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lamda1=0.01, beta=1.0):
    """FTRL-proximal, in place (see :func:`_ftrl_update`)."""
    _write((weight, z, n), _ftrl_update(weight, grad, z, n, lr, wd,
                                        rescale_grad, clip_gradient, lamda1,
                                        beta))


@torch.no_grad()
def adagrad_update(weight, grad, history, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, epsilon=1e-7):
    """AdaGrad, in place (see :func:`_adagrad_update`)."""
    _write((weight, history), _adagrad_update(
        weight, grad, history, lr, wd, rescale_grad, clip_gradient, epsilon))


@torch.no_grad()
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """signSGD, in place (see :func:`_signsgd_update`)."""
    weight.copy_(_signsgd_update(weight, grad, lr, wd, rescale_grad,
                                 clip_gradient))


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """SGD on an fp32 master, in place (see :func:`_mp_sgd_update`)."""
    _write((weight, weight32), _mp_sgd_update(
        weight, grad, weight32, lr, wd, rescale_grad, clip_gradient))


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, momentum=0.0):
    """Momentum SGD on an fp32 master, in place (see
    :func:`_mp_sgd_mom_update`)."""
    _write((weight, mom, weight32), _mp_sgd_mom_update(
        weight, grad, mom, weight32, lr, wd, rescale_grad, clip_gradient,
        momentum))


def _register_all():
    """The 13 ``*_update`` names of the registry, each the out-of-place
    form above (new weight and states returned, as the JAX ops return
    them); ``mx.nd``'s ``out=`` writes them into the given arrays."""
    from .registry import OpParam, register

    def common():
        return [OpParam("lr", float, None, required=True),
                OpParam("wd", float, 0.0),
                OpParam("rescale_grad", float, 1.0),
                OpParam("clip_gradient", float, -1.0)]

    mom = [OpParam("momentum", float, 0.0)]
    adam = [OpParam("beta1", float, 0.9), OpParam("beta2", float, 0.999),
            OpParam("epsilon", float, 1e-8)]
    lazy = [OpParam("lazy_update", bool, True)]

    def no_lazy(fn):
        def op(*arrays, lazy_update=True, **p):
            return fn(*arrays, **p)
        return op

    table = (
        ("sgd_update", 2, 1, common(), _sgd_update),
        ("sgd_mom_update", 3, 2, common() + mom + lazy,
         no_lazy(_sgd_mom_update)),
        ("nag_mom_update", 3, 2, common() + mom, _nag_mom_update),
        ("adam_update", 4, 3, common() + adam + lazy, no_lazy(_adam_update)),
        ("adamw_update", 4, 3, common() + adam + [OpParam("eta", float, 1.0)],
         _adamw_update),
        ("lamb_update_phase1", 4, 3,
         [OpParam("beta1", float, 0.9), OpParam("beta2", float, 0.999),
          OpParam("epsilon", float, 1e-6), OpParam("t", int, 1),
          OpParam("bias_correction", bool, True), OpParam("wd", float, 0.0),
          OpParam("rescale_grad", float, 1.0),
          OpParam("clip_gradient", float, -1.0)], _lamb_phase1),
        ("lamb_update_phase2", 4, 1,
         [OpParam("lr", float, None, required=True),
          OpParam("lower_bound", float, -1.0),
          OpParam("upper_bound", float, -1.0)], _lamb_phase2),
        ("rmsprop_update", 3, 2, common() + [OpParam("gamma1", float, 0.95),
                                             OpParam("epsilon", float, 1e-8)],
         _rmsprop_update),
        ("ftrl_update", 4, 3, common() + [OpParam("lamda1", float, 0.01),
                                          OpParam("beta", float, 1.0)],
         _ftrl_update),
        ("adagrad_update", 3, 2, common() + [OpParam("epsilon", float, 1e-7)],
         _adagrad_update),
        ("signsgd_update", 2, 1, common(), _signsgd_update),
        ("mp_sgd_update", 3, 2, common(), _mp_sgd_update),
        ("mp_sgd_mom_update", 4, 3, common() + mom, _mp_sgd_mom_update),
    )
    for name, n_in, n_out, params, fn in table:
        register(name, num_inputs=n_in, num_outputs=n_out, params=params,
                 differentiable=False,
                 doc=f"{name} (ref: src/operator/optimizer_op.cc); returns "
                     "the new weight (and states)")(fn)


_register_all()
