"""Device meshes (counterpart of ``mxnet_tpu/parallel/mesh.py``).

The JAX package builds every parallelism on one ``jax.sharding.Mesh``
with named axes (``data``, ``model``, ``seq``, ``pipe``). The port keeps
the same object for one device: :func:`make_mesh` names axes over a list
of devices (``Context`` objects), and an axis of size 1 tiles the one
device, so ``make_mesh({"data": 1, "model": 1})`` is what
``examples/train_imagenet.py`` builds on one card. A mesh over more than
one device (FSDP/DTensor and NCCL) is not ported yet and raises.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, gpu

__all__ = ["Mesh", "PartitionSpec", "current_mesh", "make_mesh",
           "mesh_signature", "use_mesh"]

_mesh_stack = []


class PartitionSpec(tuple):
    """How a tensor's dimensions map onto mesh axes: one entry per
    dimension, an axis name, a tuple of names or None (replicated), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """Devices arranged on named axes: ``devices`` an ndarray of
    :class:`~mxnet_tpu_torch.context.Context`, ``axis_names`` one name
    per dimension, ``shape`` {name: size}."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise MXNetError(f"mesh of {self.devices.ndim} dimensions with "
                             f"axes {self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The ``torch.device`` of a one-device mesh."""
        return self.devices.flat[0].torch_device

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def make_mesh(axes=None, devices=None) -> Mesh:
    """Name axes over ``devices`` (``Context`` objects; default: every
    CUDA device, which raises without a card). ``axes`` is a mapping or a
    list of (name, size); a size of -1 takes the devices left (like a
    reshape); default ``{"data": len(devices)}``. The sizes must tile the
    devices. A mesh of more than one device raises: multi-device meshes
    are ROADMAP Queue 1 item 9."""
    if devices is None:
        if not torch.cuda.is_available():
            raise MXNetError("make_mesh() takes the CUDA devices, but no "
                             "CUDA device is available; pass "
                             "devices=[mx.cpu()] to run on the CPU")
        devices = [gpu(i) for i in range(torch.cuda.device_count())]
    devices = [d if isinstance(d, Context) else Context(d) for d in devices]
    n = len(devices)
    items = list(axes.items()) if isinstance(axes, dict) else \
        [(k, v) for k, v in (axes or [])]
    if not items:
        items = [("data", n)]
    names = [k for k, _ in items]
    sizes = [int(v) for _, v in items]
    n_fixed = math.prod(s for s in sizes if s != -1)
    sizes = [n // max(n_fixed, 1) if s == -1 else s for s in sizes]
    if math.prod(sizes) != n:
        raise MXNetError(f"mesh axes {dict(zip(names, sizes))} do not tile "
                         f"the {n} devices given")
    if n > 1:
        raise MXNetError(f"a mesh over {n} devices is not ported yet "
                         "(ROADMAP Queue 1 item 9: FSDP/DTensor over NCCL); "
                         "the port runs one-device meshes")
    return Mesh(np.asarray(devices, dtype=object).reshape(sizes), names)


def current_mesh() -> Mesh:
    """The innermost :func:`use_mesh` scope's mesh, else
    :func:`make_mesh` over the CUDA devices."""
    if _mesh_stack:
        return _mesh_stack[-1]
    return make_mesh()


@contextmanager
def use_mesh(mesh: Mesh):
    """Scope ``mesh`` as the default mesh."""
    _mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _mesh_stack.pop()


def mesh_signature(mesh: Mesh) -> dict:
    """JSON-able identity of a mesh: device count and axis sizes."""
    return {"devices": mesh.size,
            "axes": {name: int(size) for name, size in mesh.shape.items()}}
