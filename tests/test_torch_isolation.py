"""The port stands alone: mxnet_tpu_torch and chip_smoke.py import
neither jax, the JAX package nor ml_dtypes (the card's machine has
none), and the port's entry points refuse to fall back to the CPU when
there is no CUDA device."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import resolve_device
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.serving import Server

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN


def _port_files():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_port_sources_import_no_jax():
    assert (ROOT / "chip_smoke.py").is_file()
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serving; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_cuda_means_raise_not_cpu(monkeypatch, tmp_path):
    from mxnet_tpu_torch.serving import Fleet, ReplicaPool
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmx.current_context() == tmx.gpu(0)
    with pytest.raises(MXNetError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(MXNetError, match="no CUDA device"):
        Server(nn.Activation("relu"))
    with pytest.raises(MXNetError, match="no CUDA device"):
        nn.Dense(4, in_units=3).initialize()
    with pytest.raises(MXNetError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device(tmx.cpu()) == torch.device("cpu")
    server = Server(nn.Activation("relu"), ctx=tmx.cpu())
    assert server.device == torch.device("cpu")
    with tmx.cpu():                      # a scope asks for the CPU too
        dense = nn.Dense(4, in_units=3).initialize()
        assert Server(dense).device == torch.device("cpu")
    assert dense.weight.device == torch.device("cpu")
    assert tmx.current_context() == tmx.gpu(0)
    with pytest.raises(MXNetError, match="no CUDA device"):
        Fleet()
    assert Fleet(ctx=tmx.cpu()).device == torch.device("cpu")
    # a DeployController runs nothing itself: it moves the pool's
    # servers, which built without ctx raise, so no deploy reaches the
    # CPU
    pool = ReplicaPool(str(tmp_path / "pool"))
    pool.add_local("r0", lambda: Server(nn.Activation("relu")))
    with pytest.raises(MXNetError, match="no CUDA device"):
        pool.start()
    pool.stop()


def test_no_cuda_mesh_and_sharded_trainer_raise(monkeypatch):
    """Without a card make_mesh() and a ShardedTrainer on the default mesh
    raise; a CPU mesh is what a caller asks for explicitly."""
    from mxnet_tpu_torch import parallel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(MXNetError, match="no CUDA device"):
        parallel.make_mesh({"data": 1, "model": 1})
    net = nn.Dense(2, in_units=3).initialize(ctx=tmx.cpu())
    trainer = parallel.ShardedTrainer(net, tmx.gluon.loss.L2Loss(), "sgd")
    with pytest.raises(MXNetError, match="no CUDA device"):
        trainer.step(torch.zeros(4, 3), torch.zeros(4, 2))
    mesh = parallel.make_mesh({"data": 1}, devices=[tmx.cpu()])
    trainer = parallel.ShardedTrainer(net, tmx.gluon.loss.L2Loss(), "sgd",
                                      mesh=mesh)
    assert trainer.device == torch.device("cpu")
    assert torch.isfinite(trainer.step(torch.zeros(4, 3),
                                       torch.zeros(4, 2)))
