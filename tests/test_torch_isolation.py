"""The port stands alone: mxnet_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, and the port's entry points refuse to
fall back to the CPU when there is no CUDA device."""
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
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


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
            "('jax', 'jaxlib', 'mxnet_tpu')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_cuda_means_raise_not_cpu(monkeypatch):
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
