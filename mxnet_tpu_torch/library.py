"""``mx.library`` — operator libraries loaded at run time (counterpart of
``mxnet_tpu/library.py``, ref ``include/mxnet/lib_api.h`` MXLoadLib).

Two formats, as in the JAX package:

- a **Python plugin** (``.py``), run as a module, which registers its
  operators itself with ``mxnet_tpu_torch.ops.registry.register`` (or
  ``mx.operator.register``);
- a **native plugin** (``.so``), a C library exporting the flat ABI
  below, loaded with ctypes. Each of its operators becomes a registered
  operator that computes on the host: its float32 input is copied to the
  host, the library fills the output, which goes back to the input's
  device (not differentiated, and refused inside a CUDA-graph capture,
  which cannot hold a host round trip)::

      int         mxtpu_plugin_op_count(void);
      const char* mxtpu_plugin_op_name(int i);
      // y[0..n) = f(x[0..n)); same-shape unary contract
      int         mxtpu_plugin_op_compute(int i, const float* x,
                                          float* y, long n);

After a load the new operators appear in ``mx.nd``.
"""
from __future__ import annotations

import ctypes
import importlib.util
import os

import numpy as np
import torch

from .base import MXNetError

__all__ = ["load", "loaded_libraries"]

_LOADED = {}
_HANDLES = []      # the native libraries stay loaded for the process


def loaded_libraries():
    return dict(_LOADED)


def load(path, verbose=True):
    """Load an operator library (.py or .so) and register its operators
    (ref: mx.library.load → MXLoadLib); returns their names."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise MXNetError(f"library.load: {path} does not exist")
    if path in _LOADED:
        return _LOADED[path]
    if path.endswith(".py"):
        names = _load_python(path)
    elif path.endswith((".so", ".dylib")):
        names = _load_native(path)
    else:
        raise MXNetError(f"library.load: {path}: expected a .py or .so "
                         f"op library")
    from . import ndarray as nd
    nd._expose()
    _LOADED[path] = names
    if verbose:
        print(f"loaded library {os.path.basename(path)}: "
              f"registered {names}")
    return names


def _load_python(path):
    from .ops import registry
    before = set(registry.list_ops())
    spec = importlib.util.spec_from_file_location(
        f"mxtt_plugin_{os.path.basename(path)[:-3]}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return sorted(set(registry.list_ops()) - before)


def _native_op(lib, idx, name):
    from .kernels._common import stream_capturing

    def fn(x):
        if stream_capturing():
            raise MXNetError(f"plugin op {name} computes on the host, which "
                             "a CUDA-graph capture cannot hold")
        host = np.ascontiguousarray(x.detach().float().cpu().numpy())
        out = np.empty_like(host)
        rc = lib.mxtpu_plugin_op_compute(
            idx, host.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), host.size)
        if rc != 0:
            raise MXNetError(f"plugin op {name} failed rc={rc}")
        return torch.from_numpy(out).to(x.device)
    return fn


def _load_native(path):
    from .ops.registry import register
    lib = ctypes.CDLL(path)
    try:
        lib.mxtpu_plugin_op_count.restype = ctypes.c_int
        lib.mxtpu_plugin_op_name.restype = ctypes.c_char_p
        lib.mxtpu_plugin_op_name.argtypes = [ctypes.c_int]
        lib.mxtpu_plugin_op_compute.restype = ctypes.c_int
        lib.mxtpu_plugin_op_compute.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        n_ops = lib.mxtpu_plugin_op_count()
    except AttributeError as e:
        raise MXNetError(
            f"library.load: {path} does not export the mxtpu_plugin_* "
            "ABI (see mxnet_tpu_torch/library.py)") from e
    names = []
    for i in range(n_ops):
        name = lib.mxtpu_plugin_op_name(i).decode()
        register(name, differentiable=False,
                 doc=f"plugin op from {os.path.basename(path)} (computed "
                     "on the host)")(_native_op(lib, i, name))
        names.append(name)
    _HANDLES.append(lib)
    return names
