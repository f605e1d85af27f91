"""Carry parameters from the JAX package into the port.

The JAX package names a block's parameters by structural path
(``Block._structural_names()`` there: ``features.4.0.body.1.gamma``,
``...running_var``); the port's ``state_dict()`` uses the same keys. The
arrays travel as numpy, e.g.
``{k: p.data().asnumpy() for k, p in net._structural_names().items()}``.

One JAX parameter has two structural names: BERT's position table is the
attribute ``position_weight`` of a parameter named ``position_embed``, and
``_structural_names()`` yields the same array under both. The port holds
it once, as ``position_weight``. :func:`load_jax_params` drops an alias
(:data:`ALIASES`) that the block does not have when the array under its
canonical name is present and equal to it; an alias whose array differs
raises, since one of the two would be lost.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .base import MXNetError

__all__ = ["ALIASES", "load_jax_params", "params_from_jax"]

# structural-name suffix of an alias → suffix of the name the port keeps
ALIASES = {"position_embed": "position_weight"}


def params_from_jax(arrays: Mapping[str, np.ndarray]) -> dict:
    """``{structural name: numpy array}`` → a state dict of CPU tensors
    (copies, so read-only JAX buffers are fine)."""
    return {str(k): torch.tensor(np.asarray(v)) for k, v in arrays.items()}


def _drop_aliases(block, arrays: Mapping[str, np.ndarray]) -> dict:
    """``arrays`` without the aliases of names the block holds once."""
    own = set(block.state_dict(keep_vars=True))
    out = dict(arrays)
    for key in arrays:
        prefix, _, last = str(key).rpartition(".")
        if last not in ALIASES or key in own:
            continue
        canonical = f"{prefix}.{ALIASES[last]}" if prefix else ALIASES[last]
        if canonical not in arrays or canonical not in own:
            continue
        if not np.array_equal(np.asarray(arrays[key]),
                              np.asarray(arrays[canonical])):
            raise MXNetError(f"JAX parameters {key!r} and {canonical!r} name "
                             "one parameter but hold different arrays")
        del out[key]
    return out


def load_jax_params(block, arrays: Mapping[str, np.ndarray], strict=True,
                    ctx=None):
    """Load the JAX package's parameters into a port ``block``. With
    ``strict`` (the default) missing keys, extra keys and shape
    mismatches raise :class:`~mxnet_tpu_torch.base.MXNetError`; a shape
    mismatch raises either way, and so does an alias that differs from
    its canonical array (see the module docstring). Parameters not yet
    materialized take the loaded shapes, on the device ``initialize``
    chose, else on ``ctx`` (default ``cuda:0``)."""
    state = {k: v.numpy() for k, v in
             params_from_jax(_drop_aliases(block, arrays)).items()}
    return block.load_dict(state, ctx=ctx, allow_missing=not strict,
                           ignore_extra=not strict, source="JAX parameters")
