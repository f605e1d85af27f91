"""Fused optimizer updates (counterpart of
``mxnet_tpu/ops/optimizer_op.py``, ref ``src/operator/optimizer_op.cc``).

Each update reads the gradient, rescales, clips and adds weight decay in
fp32 (:func:`_prep_grad`). The out-of-place forms (:func:`_sgd_update`,
:func:`_sgd_mom_update`, :func:`_adam_update`) return the new weight and
state, as the JAX ops do, and take ``lr`` and ``rescale_grad`` as Python
numbers or 0-d tensors on the weight's device (a CUDA graph reads those
where they live, so an lr change replays the same graph). The public
forms write the new values into the given tensors in place under
``torch.no_grad()`` (the JAX package returns new arrays; the port saves
the copies). The arithmetic follows the JAX ops term for term, in fp32,
cast back to each tensor's dtype.
"""
from __future__ import annotations

import torch

__all__ = ["adam_update", "sgd_mom_update", "sgd_update"]


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
    w, m = _sgd_mom_update(weight, grad, mom, lr, wd, rescale_grad,
                           clip_gradient, momentum)
    weight.copy_(w)
    mom.copy_(m)


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """Adam without bias correction (the Optimizer folds it into
    ``lr``): ``mean = beta1 mean + (1 - beta1) g``, ``var = beta2 var +
    (1 - beta2) g^2``, ``weight -= lr mean / (sqrt(var) + epsilon)``."""
    for t, v in zip((weight, mean, var),
                    _adam_update(weight, grad, mean, var, lr, wd,
                                 rescale_grad, clip_gradient, beta1, beta2,
                                 epsilon)):
        t.copy_(v)
