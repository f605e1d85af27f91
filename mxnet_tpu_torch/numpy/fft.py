"""``mx.np.fft`` (counterpart of the JAX package's ``mx.np.fft``, ref
``numpy.fft``): ``torch.fft`` with NumPy's argument names, on NDArrays
(complex64 from float32, as JAX with 64-bit types off)."""
from __future__ import annotations

import torch

from . import _a, _device, _float, _make

__all__ = ["fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "fftn", "ifftn",
           "fftfreq", "rfftfreq", "fftshift", "ifftshift"]


def _one(fn):
    return lambda a, n=None, axis=-1, norm=None: fn(_float(a), n=n, dim=axis,
                                                    norm=norm)


def _many(fn, default_axes=None):
    return lambda a, s=None, axes=default_axes, norm=None: fn(
        _float(a), s=s, dim=axes, norm=norm)


_IMPL = {
    "fft": _one(torch.fft.fft), "ifft": _one(torch.fft.ifft),
    "rfft": _one(torch.fft.rfft), "irfft": _one(torch.fft.irfft),
    "fft2": _many(torch.fft.fft2, (-2, -1)),
    "ifft2": _many(torch.fft.ifft2, (-2, -1)),
    "fftn": _many(torch.fft.fftn), "ifftn": _many(torch.fft.ifftn),
    "fftfreq": lambda n, d=1.0, **kw: torch.fft.fftfreq(
        n, d, device=_device()),
    "rfftfreq": lambda n, d=1.0, **kw: torch.fft.rfftfreq(
        n, d, device=_device()),
    "fftshift": lambda x, axes=None: torch.fft.fftshift(_a(x), dim=axes),
    "ifftshift": lambda x, axes=None: torch.fft.ifftshift(_a(x),
                                                          dim=axes),
}

for _name, _fn in _IMPL.items():
    globals()[_name] = _make(_name, _fn)
