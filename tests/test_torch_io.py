"""``mx.io``'s iterator core in the port against the JAX package, on the
CPU: ``NDArrayIter``'s batches, pads, indices and provide_* for each
``last_batch_handle``, with shuffling from the same numpy seed, the
``num_parts`` / ``part_index`` shards, ``DataBatch`` / ``DataDesc``, and
the iterators that wait for ROADMAP Queue 1 item 11. Batches are held
exactly (they are copies of the same numpy rows)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()


def _arrays(n=11):
    rng = np.random.RandomState(3)
    return (rng.randn(n, 2, 3).astype(np.float32),
            rng.randint(0, 5, n).astype(np.float32))


def _epochs(io, data, label, epochs=2, seed=None, **kw):
    """Every batch of ``epochs`` epochs as numpy, with pad and index."""
    if seed is not None:
        np.random.seed(seed)
    it = io.NDArrayIter(data, label, **kw)
    out = [[(d.shape, str(d.dtype)) for d in it.provide_data],
           [(d.name, d.shape) for d in it.provide_label]]
    for _ in range(epochs):
        for batch in it:
            out.append(([d.asnumpy() for d in batch.data],
                        [lb.asnumpy() for lb in batch.label],
                        batch.pad, None if batch.index is None
                        else list(batch.index)))
        it.reset()
    return out


def _same(got, want):
    assert got[:2] == want[:2]
    assert len(got) == len(want)
    for g, w in zip(got[2:], want[2:]):
        for ga, wa in zip(g[0] + g[1], w[0] + w[1]):
            assert ga.dtype == wa.dtype
            np.testing.assert_array_equal(ga, wa)
        assert g[2:] == w[2:]


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarrayiter_batches_as_jax(handle, shuffle):
    data, label = _arrays()
    kw = dict(batch_size=4, shuffle=shuffle, last_batch_handle=handle)
    with CPU:
        got = _epochs(tmx.io, data, label, seed=7, **kw)
    want = _epochs(jmx.io, data, label, seed=7, **kw)
    _same(got, want)


@pytest.mark.parametrize("num_parts,part_index", [(3, 0), (3, 1), (3, 2),
                                                  (4, 3)])
def test_ndarrayiter_parts_as_jax(num_parts, part_index):
    data, label = _arrays(13)
    kw = dict(batch_size=3, num_parts=num_parts, part_index=part_index)
    with CPU:
        got = _epochs(tmx.io, data, label, epochs=1, **kw)
    want = _epochs(jmx.io, data, label, epochs=1, **kw)
    _same(got, want)


def test_ndarrayiter_dict_inputs_and_names():
    data, label = _arrays(6)
    for io, scope in ((tmx.io, CPU), (jmx.io, None)):
        it = io.NDArrayIter({"a": data, "b": data[:, 0]}, None,
                            batch_size=2)
        assert [d.name for d in it.provide_data] == ["a", "b"]
        assert it.provide_label == []
    with CPU:
        it = tmx.io.NDArrayIter([data, data], label, batch_size=5)
        assert [d.name for d in it.provide_data] == ["_0_data", "_1_data"]
    with pytest.raises(MXNetError, match="share dim 0"):
        tmx.io.NDArrayIter(data, label[:3])
    with pytest.raises(MXNetError, match="part_index"):
        tmx.io.NDArrayIter(data, label, num_parts=2, part_index=2)


def test_data_batch_and_desc_as_jax():
    for io in (tmx.io, jmx.io):
        desc = io.DataDesc("data", (4, 3), layout="NC")
        assert desc.name == "data" and desc.shape == (4, 3)
        assert desc.layout == "NC" and desc.dtype == np.float32
        assert io.DataDesc.get_batch_axis("TNC") == 1
        batch = io.DataBatch(data=np.zeros(2), label=None, pad=1)
        assert len(batch.data) == 1 and batch.label is None and \
            batch.pad == 1


@pytest.mark.parametrize("name", ["ResizeIter", "PrefetchingIter",
                                  "CSVIter", "MNISTIter", "ImageRecordIter",
                                  "ImageDetRecordIter", "LibSVMIter"])
def test_deferred_iterators_raise(name):
    assert hasattr(jmx.io, name) or name == "ImageDetRecordIter"
    with pytest.raises(MXNetError, match="Queue 1 item 11"):
        getattr(tmx.io, name)(None)
