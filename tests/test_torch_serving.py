"""The port's Server (mxnet_tpu_torch/serving) on the CPU: concurrent
requests answered with the model's logits (port forward and JAX logits
at atol = rtol = 1e-4, as for the ResNet parity), bucket padding and
cropping, admission shedding, drain and no-drain stop, and bucket-grid
parity with the JAX package's copy."""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.serving.buckets import BucketGrid as JaxGrid
from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.serving import (BucketGrid, RequestError, Server,
                                     ServerConfig, ServerOverloaded,
                                     ServerStopped)

from torch_parity import narrow_pair


def test_concurrent_requests_match_port_and_jax_logits():
    n = 12
    x = np.random.RandomState(0).randn(n, 3, 32, 32).astype(np.float32)
    jnet, tnet = narrow_pair(seed=1, in_shape=x.shape)
    want = jnet(jnd.array(x)).asnumpy()
    server = Server(tnet, ServerConfig(max_batch=4, window_ms=20),
                    ctx=tmx.cpu()).start()
    results = [None] * n

    def client(idx):
        for i in idx:
            results[i] = server.predict(x[i], timeout_s=60)

    threads = [threading.Thread(target=client, args=(range(k, n, 4),))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    server.stop()
    stats = server.stats()
    assert stats["served"] == n and stats["errors"] == 0
    assert 3 <= stats["batches"] <= n
    assert stats["latency_ms"]["count"] == n
    for i in range(n):
        with torch.inference_mode():
            own = tnet(torch.from_numpy(x[i:i + 1])).numpy()[0]
        assert results[i].shape == (10,)
        np.testing.assert_allclose(results[i], own, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(results[i], want[i], rtol=1e-4,
                                   atol=1e-4)


def test_bucket_padding_and_cropping():
    server = Server(tnn.Activation("relu"),
                    ServerConfig(max_batch=4, dim_buckets={0: (4, 8)},
                                 pad_value=-1.0, window_ms=1),
                    ctx=tmx.cpu()).start()
    rng = np.random.RandomState(2)
    xs = [rng.randn(k).astype(np.float32) for k in (3, 6, 8, 1)]
    pending = [server.submit(x) for x in xs]
    for x, p in zip(xs, pending):
        out = p.result(30)
        assert out.shape == x.shape
        np.testing.assert_array_equal(out, np.maximum(x, 0))
    with pytest.raises(RequestError, match="exceeds the bucket grid"):
        server.submit(np.zeros(9, np.float32))
    server.stop()
    assert server.stats()["rejected_shape"] == 1
    assert server.cache.stats()["misses"] == 2     # buckets 4 and 8


def test_full_queue_sheds_and_drain_stop_answers_admitted():
    server = Server(tnn.Activation("relu"),
                    ServerConfig(max_queue=2, window_ms=1), ctx=tmx.cpu())
    xs = [np.full(3, i, np.float32) for i in range(2)]
    pending = [server.submit(x) for x in xs]
    with pytest.raises(ServerOverloaded):
        server.submit(xs[0])
    server.start()
    server.stop(drain=True)
    for x, p in zip(xs, pending):
        np.testing.assert_array_equal(p.result(5), x)
    assert server.stats()["shed"] == 1
    with pytest.raises(ServerStopped):
        server.submit(xs[0])


class _Gate(HybridBlock):
    """Holds the worker inside a batch until released."""

    def __init__(self):
        super().__init__()
        self.entered = threading.Event()
        self.release = threading.Event()

    def forward(self, x):
        self.entered.set()
        self.release.wait(30)
        return x * 2


def test_no_drain_stop_fails_what_was_not_served():
    gate = _Gate()
    server = Server(gate, ServerConfig(window_ms=0), ctx=tmx.cpu()).start()
    first = server.submit(np.ones(2, np.float32))
    assert gate.entered.wait(30)
    rest = [server.submit(np.ones(2, np.float32)) for _ in range(3)]
    stopper = threading.Thread(target=server.stop,
                               kwargs={"drain": False, "timeout_s": 30})
    stopper.start()
    for _ in range(3000):
        if server._stopping.is_set():
            break
        time.sleep(0.01)
    gate.release.set()
    stopper.join(timeout=60)
    assert not stopper.is_alive()
    np.testing.assert_array_equal(first.result(5), np.full(2, 2.0))
    for p in rest:
        with pytest.raises(ServerStopped):
            p.result(5)
    assert server.stats()["rejected_stopped"] == 3


@pytest.mark.parametrize("max_batch,batch_buckets,dim_buckets", [
    (8, None, None),
    (5, None, {0: (4, 16)}),
    (16, (1, 3, 16), {1: (7, 14, 28), 0: (2,)}),
])
def test_bucket_grid_matches_jax(max_batch, batch_buckets, dim_buckets):
    ours = BucketGrid(max_batch, batch_buckets, dim_buckets)
    theirs = JaxGrid(max_batch, batch_buckets, dim_buckets)
    assert ours.batch_buckets == theirs.batch_buckets
    assert ours.grid_bound() == theirs.grid_bound()
    for n in range(0, max_batch + 3):
        assert ours.batch_bucket(n) == theirs.batch_bucket(n)
    rng = np.random.RandomState(max_batch)
    for _ in range(50):
        shape = tuple(int(d) for d in rng.randint(1, 32, size=rng.randint(
            1, 4)))
        assert ours.feature_key(shape) == theirs.feature_key(shape)
