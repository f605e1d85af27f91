"""Fused optimizer updates (counterpart of
``mxnet_tpu/ops/optimizer_op.py``, ref ``src/operator/optimizer_op.cc``).

Each update reads the gradient, rescales, clips and adds weight decay in
fp32 (:func:`_prep_grad`), then writes the new weight and state into the
given tensors in place under ``torch.no_grad()`` (the JAX package returns
new arrays; the port saves the copies). The arithmetic follows the JAX
ops term for term, in fp32, cast back to each tensor's dtype.
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


@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """``weight -= lr * (rescale * clip(grad) + wd * weight)``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient, wd)
    weight.copy_(weight.float() - lr * g)


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, momentum=0.0):
    """Momentum SGD: ``mom = momentum * mom - lr * g``, ``weight +=
    mom``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient, wd)
    mom_new = momentum * mom.float() - lr * g
    weight.copy_(weight.float() + mom_new)
    mom.copy_(mom_new)


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """Adam without bias correction (the Optimizer folds it into
    ``lr``): ``mean = beta1 mean + (1 - beta1) g``, ``var = beta2 var +
    (1 - beta2) g^2``, ``weight -= lr mean / (sqrt(var) + epsilon)``."""
    g = _prep_grad(weight, grad, rescale_grad, clip_gradient, wd)
    mean_new = beta1 * mean.float() + (1 - beta1) * g
    var_new = beta2 * var.float() + (1 - beta2) * torch.square(g)
    weight.copy_(weight.float()
                 - lr * mean_new / (torch.sqrt(var_new) + epsilon))
    mean.copy_(mean_new)
    var.copy_(var_new)
