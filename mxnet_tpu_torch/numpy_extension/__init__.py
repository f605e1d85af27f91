"""``mx.npx`` — the NumPy-extension namespace (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``, ref ``python/mxnet/
numpy_extension/`` and the ``_npx_*`` operators): neural-network
operators with NumPy calling conventions over the port's ``mx.nd``
operators (the same numerics and autograd), and the np-mode switches.
``rnn`` waits for ROADMAP Queue 1 item 7 and ``box_nms`` for item 10:
both raise naming it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import ndarray as nd
from ..base import MXNetError
from ..numpy import _a, _call

__all__ = ["set_np", "reset_np", "is_np_array", "softmax", "log_softmax",
           "relu", "sigmoid", "gelu", "leaky_relu", "batch_norm",
           "layer_norm", "fully_connected", "convolution", "pooling",
           "one_hot", "pick", "topk", "embedding", "dropout", "seed",
           "batch_dot", "gather_nd", "reshape_like", "broadcast_like",
           "arange_like", "sequence_mask", "smooth_l1", "slice",
           "slice_like", "waitall", "activation", "cast", "erf", "erfinv",
           "gamma", "gammaln", "deconvolution", "ctc_loss", "group_norm",
           "instance_norm", "box_nms", "rnn"]

_np_mode = {"array": False, "shape": False}


def set_np(shape=True, array=True):
    """ref: npx.set_np. The port's arrays already follow NumPy's shape
    rules; the flag is kept for scripts that read it."""
    _np_mode["array"] = array
    _np_mode["shape"] = shape


def reset_np():
    set_np(False, False)


def is_np_array():
    return _np_mode["array"]


def softmax(x, axis=-1):
    return _call(lambda a: torch.softmax(_a(a), axis), x)


def log_softmax(x, axis=-1):
    return _call(lambda a: torch.log_softmax(_a(a), axis), x)


def relu(x):
    return _call(torch.relu, x)


def sigmoid(x):
    return _call(torch.sigmoid, x)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return _call(lambda a: F.gelu(a, approximate="tanh"), x)


def leaky_relu(x, slope=0.01):
    return _call(lambda a: F.leaky_relu(a, slope), x)


def one_hot(x, depth, on_value=1.0, off_value=0.0, dtype=None):
    def run(a):
        hot = F.one_hot(a.to(torch.int64) % depth, depth).to(torch.float32)
        hot = torch.where(((a >= 0) & (a < depth)).unsqueeze(-1), hot,
                          torch.zeros_like(hot))
        return hot * (on_value - off_value) + off_value
    return _call(run, x)


def pick(data, index, axis=-1, keepdims=False):
    return nd.pick(data, index, axis=axis, keepdims=keepdims)


def topk(data, k=1, axis=-1, ret_typ="indices", is_ascend=False):
    return nd.topk(data, k=k, axis=axis, ret_typ=ret_typ,
                   is_ascend=is_ascend)


def embedding(data, weight, input_dim=None, output_dim=None, dtype=None):
    return nd.Embedding(data, weight,
                        input_dim=input_dim or weight.shape[0],
                        output_dim=output_dim or weight.shape[1])


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    args = [x, weight] + ([] if bias is None else [bias])
    return nd.FullyConnected(*args, num_hidden=num_hidden or weight.shape[0],
                             no_bias=bias is None or no_bias,
                             flatten=flatten)


def convolution(data, weight, bias=None, **kwargs):
    args = [data, weight] + ([] if bias is None else [bias])
    if bias is None:
        kwargs.setdefault("no_bias", True)
    return nd.Convolution(*args, **kwargs)


def pooling(data, **kwargs):
    return nd.Pooling(data, **kwargs)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-3,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1):
    return nd.BatchNorm(x, gamma, beta, running_mean, running_var, eps=eps,
                        momentum=momentum, fix_gamma=fix_gamma,
                        use_global_stats=use_global_stats,
                        output_mean_var=output_mean_var, axis=axis)


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    return nd.LayerNorm(x, gamma, beta, axis=axis, eps=eps)


def dropout(x, p=0.5, **kwargs):
    return nd.Dropout(x, p=p, **kwargs)


def seed(s):
    from .. import random as _random
    _random.seed(s)


def batch_dot(a, b, transpose_a=False, transpose_b=False):
    return nd.batch_dot(a, b, transpose_a=transpose_a,
                        transpose_b=transpose_b)


def gather_nd(data, indices):
    return nd.gather_nd(data, indices)


def reshape_like(lhs, rhs):
    return nd.reshape_like(lhs, rhs)


def broadcast_like(lhs, rhs):
    return nd.broadcast_like(lhs, rhs)


def arange_like(data, start=0.0, step=1.0, axis=None):
    return nd.arange_like(data, start=start, step=step, axis=axis)


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """The flag decides, as in the reference: without it the data pass
    unmasked; with it the lengths are required."""
    if use_sequence_length and sequence_length is None:
        raise MXNetError("sequence_mask: use_sequence_length=True "
                         "requires a sequence_length tensor")
    args = [data] + ([sequence_length] if use_sequence_length else [])
    return nd.SequenceMask(*args, use_sequence_length=use_sequence_length,
                           value=value, axis=axis)


def smooth_l1(data, scalar=1.0):
    return nd.smooth_l1(data, scalar=scalar)


def slice(data, begin, end, step=None):        # noqa: A001 (ref name)
    kwargs = {"begin": begin, "end": end}
    if step is not None:
        kwargs["step"] = step
    return nd.slice(data, **kwargs)


def slice_like(data, shape_like, axes=None):
    return nd.slice_like(data, shape_like, axes=axes)


def waitall():
    nd.waitall()


def activation(data, act_type="relu"):
    return nd.Activation(data, act_type=act_type)


def cast(data, dtype):
    return nd.cast(data, dtype=dtype)


def erf(data):
    return nd.erf(data)


def erfinv(data):
    return nd.erfinv(data)


def gamma(data):
    return nd.gamma(data)


def gammaln(data):
    return nd.gammaln(data)


def deconvolution(data, weight, bias=None, **kwargs):
    args = [data, weight] + ([bias] if bias is not None else [])
    kwargs.setdefault("no_bias", bias is None)
    return nd.Deconvolution(*args, **kwargs)


def ctc_loss(data, label, data_lengths=None, label_lengths=None, **kwargs):
    args = [data, label]
    if data_lengths is not None:
        args.append(data_lengths)
        kwargs.setdefault("use_data_lengths", True)
    if label_lengths is not None:
        args.append(label_lengths)
        kwargs.setdefault("use_label_lengths", True)
    return nd.CTCLoss(*args, **kwargs)


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    return nd.GroupNorm(data, gamma, beta, num_groups=num_groups, eps=eps)


def instance_norm(data, gamma, beta, eps=1e-3):
    return nd.InstanceNorm(data, gamma, beta, eps=eps)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner"):
    """ref: npx.box_nms — the detection operators are ROADMAP Queue 1
    item 10."""
    raise MXNetError("npx.box_nms is not ported yet: ROADMAP Queue 1 item "
                     "10 (detection)")


def rnn(data, parameters, state, state_cell=None, sequence_length=None,
        mode="lstm", state_size=None, num_layers=1, **kwargs):
    """ref: npx.rnn — the fused RNN operator is ROADMAP Queue 1 item 7."""
    raise MXNetError("npx.rnn is not ported yet: ROADMAP Queue 1 item 7 "
                     "(gluon/rnn)")
