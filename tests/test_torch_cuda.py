"""Tests of the port that need an NVIDIA card (marker ``cuda``): the
hand-written conv-epilogue kernel against its plain version on CUDA
tensors, its launch count, and its refusals. Without a card they skip;
on the card run them with ``python -m pytest -m cuda --noconftest
tests/test_torch_cuda.py`` (the suite's conftest imports the JAX
package)."""
import pytest
import torch

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import conv_epilogue as ce

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("act", ce.EPILOGUE_ACTS)
@pytest.mark.parametrize("shape,axis,vectors,with_res", [
    ((8, 64, 56, 56), 1, True, False),
    ((2, 2048, 7, 7), 1, False, True),
    ((77, 13), -1, True, True),
    ((3, 5, 7, 11), 2, True, True),
])
def test_kernel_matches_plain(cuda, shape, axis, vectors, with_res, act,
                              dtype, tol):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn(*shape, generator=gen, device=cuda).to(dtype)
    c = shape[axis]
    s = (torch.rand(c, generator=gen, device=cuda) + 0.5).to(dtype) \
        if vectors else None
    b = (torch.randn(c, generator=gen, device=cuda) * 0.1).to(dtype) \
        if vectors else None
    r = torch.randn(*shape, generator=gen, device=cuda).to(dtype) \
        if with_res else None
    kernels.reset_launch_counts()
    got = ce.fused_conv_epilogue(x, s, b, r, channel_axis=axis,
                                 act_type=act)
    assert kernels.launch_counts() == {"conv_epilogue": 1}
    want = ce.fused_conv_epilogue_plain(x, s, b, r, channel_axis=axis,
                                        act_type=act)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn(2, 4, 3, 3, device=cuda)
    with pytest.raises(MXNetError, match="contiguous"):
        ce.fused_conv_epilogue(x.transpose(2, 3), res=x.transpose(2, 3))
    with pytest.raises(MXNetError, match="dtype"):
        ce.fused_conv_epilogue(x.double(), res=x.double())
    with pytest.raises(MXNetError, match="requires grad"):
        ce.fused_conv_epilogue(x.requires_grad_(), res=x)
