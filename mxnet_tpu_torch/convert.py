"""Carry parameters from the JAX package into the port.

The JAX package names a block's parameters by structural path
(``Block._structural_names()`` there: ``features.4.0.body.1.gamma``,
``...running_var``); the port's ``state_dict()`` uses the same keys. The
arrays travel as numpy, e.g.
``{k: p.data().asnumpy() for k, p in net._structural_names().items()}``.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["load_jax_params", "params_from_jax"]


def params_from_jax(arrays: Mapping[str, np.ndarray]) -> dict:
    """``{structural name: numpy array}`` → a state dict of CPU tensors
    (copies, so read-only JAX buffers are fine)."""
    return {str(k): torch.tensor(np.asarray(v)) for k, v in arrays.items()}


def load_jax_params(block, arrays: Mapping[str, np.ndarray], strict=True,
                    ctx=None):
    """Load the JAX package's parameters into a port ``block``. With
    ``strict`` (the default) missing keys, extra keys and shape
    mismatches raise :class:`~mxnet_tpu_torch.base.MXNetError`; a shape
    mismatch raises either way. Parameters not yet materialized take the
    loaded shapes, on the device ``initialize`` chose, else on ``ctx``
    (default ``cuda:0``)."""
    state = {k: v.numpy() for k, v in params_from_jax(arrays).items()}
    return block.load_dict(state, ctx=ctx, allow_missing=not strict,
                           ignore_extra=not strict, source="JAX parameters")
