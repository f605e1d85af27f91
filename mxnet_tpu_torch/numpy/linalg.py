"""``mx.np.linalg`` (counterpart of the JAX package's ``mx.np.linalg``,
ref ``numpy.linalg``): ``torch.linalg`` with NumPy's signatures, on
NDArrays; ``lstsq`` returns NumPy's four results."""
from __future__ import annotations

import torch

from . import _a, _float, _make

__all__ = ["norm", "inv", "det", "slogdet", "cholesky", "qr", "svd", "eig",
           "eigh", "eigvals", "eigvalsh", "solve", "lstsq", "matrix_rank",
           "matrix_power", "pinv", "tensorsolve", "tensorinv", "multi_dot"]


def _norm(x, ord=None, axis=None, keepdims=False):
    return torch.linalg.norm(_float(x), ord=ord, dim=axis, keepdim=keepdims)


def _qr(a, mode="reduced"):
    q, r = torch.linalg.qr(_float(a), mode=mode)
    return r if mode == "r" else (q, r)


def _svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    a = _float(a)
    if not compute_uv:
        return torch.linalg.svdvals(a)
    return torch.linalg.svd(a, full_matrices=full_matrices)


def _eigh(a, UPLO="L", symmetrize_input=True):
    return torch.linalg.eigh(_float(a), UPLO=UPLO)


def _lstsq(a, b, rcond=None, **kw):
    """NumPy's (solution, residuals, rank, singular values): the
    residuals are the squared 2-norms of b - a x per column when a has
    full column rank and more rows than columns, else empty."""
    a, b = _float(a), _float(b).to(_float(a).dtype)
    m, n = a.shape[-2:]
    s = torch.linalg.svdvals(a)
    tol = (rcond if rcond is not None and rcond >= 0
           else torch.finfo(a.dtype).eps * max(m, n)) * s.max()
    x = torch.linalg.pinv(a, rtol=tol / s.max()) @ b
    rank = (s > tol).sum()
    if int(rank) == n and m > n:
        r = b - a @ x
        res = (r * r).sum(0)
    else:
        res = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return x, res, rank, s


def _multi_dot(arrays, **kw):
    return torch.linalg.multi_dot([_a(x) for x in arrays])


_IMPL = {
    "norm": _norm,
    "inv": lambda a: torch.linalg.inv(_float(a)),
    "det": lambda a: torch.linalg.det(_float(a)),
    "slogdet": lambda a: tuple(torch.linalg.slogdet(_float(a))),
    "cholesky": lambda a, **kw: torch.linalg.cholesky(_float(a)),
    "qr": _qr, "svd": _svd,
    "eig": lambda a: tuple(torch.linalg.eig(_float(a))),
    "eigh": lambda a, UPLO="L", **kw: tuple(_eigh(a, UPLO)),
    "eigvals": lambda a: torch.linalg.eigvals(_float(a)),
    "eigvalsh": lambda a, UPLO="L": torch.linalg.eigvalsh(_float(a), UPLO),
    "solve": lambda a, b: torch.linalg.solve(_float(a), _float(b)),
    "lstsq": _lstsq,
    "matrix_rank": lambda M, tol=None, **kw: torch.linalg.matrix_rank(
        _float(M), atol=tol),
    "matrix_power": lambda a, n: torch.linalg.matrix_power(_a(a), n),
    "pinv": lambda a, rcond=None, hermitian=False, **kw:
    torch.linalg.pinv(_float(a), hermitian=hermitian) if rcond is None
    else torch.linalg.pinv(_float(a), rtol=rcond, hermitian=hermitian),
    "tensorsolve": lambda a, b, axes=None: torch.linalg.tensorsolve(
        _float(a), _float(b), dims=axes),
    "tensorinv": lambda a, ind=2: torch.linalg.tensorinv(_float(a), ind),
    "multi_dot": _multi_dot,
}

for _name, _fn in _IMPL.items():
    globals()[_name] = _make(_name, _fn)
