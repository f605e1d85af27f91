"""Helpers of the replica-tier tests (tests/test_torch_pool.py,
tests/test_torch_router.py): the worker's ``mlp`` in both packages with
one seeded set of weights (carried into the port through ``convert``),
pools of in-process replicas over it, journals read back, and a fault
hook that slows one replica's router attempts."""
import json
import os
import time

import numpy as np

import mxnet_tpu_torch as tmx
from mxnet_tpu.diagnostics.journal import reset_journal as jreset
from mxnet_tpu.serving import PoolConfig as JPoolConfig
from mxnet_tpu.serving import ReplicaPool as JPool
from mxnet_tpu.serving import Server as JServer
from mxnet_tpu.serving import ServerConfig as JServerConfig
from mxnet_tpu.serving.worker import _build_block as jbuild
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.diagnostics.journal import reset_journal as treset
from mxnet_tpu_torch.serving import PoolConfig as TPoolConfig
from mxnet_tpu_torch.serving import ReplicaPool as TPool
from mxnet_tpu_torch.serving import Server as TServer
from mxnet_tpu_torch.serving import ServerConfig as TServerConfig
from mxnet_tpu_torch.serving.worker import _build_block as tbuild

DIM = 16
PKGS = ("jax", "port")


def mlp_arrays(seed=0, scale=1.0):
    """Seeded weights of the worker's mlp (Dense(32, relu), Dense(8))."""
    rng = np.random.RandomState(seed)
    shapes = {"0.weight": (32, DIM), "0.bias": (32,), "1.weight": (8, 32),
              "1.bias": (8,)}
    return {k: (scale * 0.3 * rng.randn(*s)).astype(np.float32)
            for k, s in shapes.items()}


def mlp(pkg, arrays=None):
    arrays = mlp_arrays() if arrays is None else arrays
    if pkg == "jax":
        from mxnet_tpu import nd
        net = jbuild("mlp", DIM)
        net(nd.array(np.zeros((1, DIM), np.float32)))
        for k, p in net._structural_names().items():
            p.set_data(nd.array(arrays[k]))
        return net
    net = tbuild("mlp", DIM, tmx.cpu())
    load_jax_params(net, arrays)
    return net


def mlp_forward(x, arrays=None):
    a = mlp_arrays() if arrays is None else arrays
    h = np.maximum(x @ a["0.weight"].T + a["0.bias"], 0.0)
    return h @ a["1.weight"].T + a["1.bias"]


def server(pkg, store=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("window_ms", 1.0)
    if pkg == "jax":
        return JServer(mlp("jax"), config=JServerConfig(**kw),
                       param_store=store)
    return TServer(mlp("port"), TServerConfig(**kw), param_store=store,
                   ctx=tmx.cpu())


def local_pool(pkg, root, n=2, factory=None, heartbeat_s=0.1,
               deadline_s=0.6, **pool_kw):
    cls, cfg = (JPool, JPoolConfig) if pkg == "jax" else (TPool, TPoolConfig)
    pool = cls(root, cfg(heartbeat_s=heartbeat_s, deadline_s=deadline_s,
                         **pool_kw))
    for i in range(n):
        pool.add_local(f"r{i}", factory or (lambda: server(pkg)))
    return pool


def journal_to(pkg, path):
    (jreset if pkg == "jax" else treset)(path)


def quiet_journals():
    jreset("off")
    treset("off")


def records(path, kind=None):
    out = []
    if not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if kind is None or rec.get("kind") == kind:
                out.append(rec)
    return out


def wait(cond, timeout_s=30.0, poll_s=0.01):
    t_end = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < t_end, "timed out"
        time.sleep(poll_s)


def slow_hook(replica, delay_s):
    """A fault hook (either package's ``atomic.set_fault_hook``) that
    delays every router attempt on ``replica``."""
    def hook(point, path=None, nbytes=None, size=None):
        if point == "router_attempt" and path == replica:
            time.sleep(delay_s)
    return hook


def commit_mlp(root, step, arrays):
    """Commit the mlp's ``arrays`` as step ``step`` under ``root`` (the
    port's ``.params`` container, which both packages read)."""
    from mxnet_tpu_torch import ndarray as tnd
    from mxnet_tpu_torch.resilience import commit as tcommit
    stage = tcommit.prepare_stage(root, step)
    tnd.save(os.path.join(stage, "model.params"), dict(arrays))
    return tcommit.finalize(root, step)
