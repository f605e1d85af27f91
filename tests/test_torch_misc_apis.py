"""The small modules of the port against the JAX package's, on the CPU:
``mx.library`` (a Python plugin and the native ``.so`` ABI, built from
``native/example_plugin.cc`` and checked as tests/test_extensions.py
checks the JAX package's; the operators leave the registry after each
test),
``mx.runtime``, ``mx.name`` and ``mx.attribute`` scopes (the scope
semantics of tests/test_misc_parity.py, and the symbols that read them:
names and ``__key__`` attributes as the JAX package's), ``mx.util`` (tests/test_compat_apis.py's
util tests) and ``mx.test_utils``. Also: the item-6 names of ``mx.nd``
resolve, and no module of the port imports JAX."""
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def registry_kept():
    """The port's registry and mx.nd as they were: a plugin's operators
    leave with the test (other tests count the registered names)."""
    from mxnet_tpu_torch.ops import registry
    before = set(registry._REGISTRY)
    yield
    for name in set(registry._REGISTRY) - before:
        del registry._REGISTRY[name]
        for ns in (tmx.nd, tmx.nd.op):
            ns.__dict__.pop(name, None)
        if hasattr(tmx.nd.NDArray, name):
            delattr(tmx.nd.NDArray, name)
    tmx.library._LOADED.clear()


def test_python_plugin(tmp_path, registry_kept):
    plug = tmp_path / "tplug.py"
    plug.write_text(
        "from mxnet_tpu_torch.ops.registry import register\n"
        "@register('plugin_cube_port', doc='x^3')\n"
        "def _cube(x):\n"
        "    return x * x * x\n")
    names = tmx.library.load(str(plug), verbose=False)
    assert names == ["plugin_cube_port"]
    assert tmx.library.load(str(plug), verbose=False) == names
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    np.testing.assert_allclose(
        tmx.nd.plugin_cube_port(tmx.nd.array(x, ctx=CPU)).asnumpy(), x ** 3,
        atol=1e-5)
    assert str(tmp_path / "tplug.py") in tmx.library.loaded_libraries()


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_native_plugin(tmp_path, registry_kept):
    """The example plugin's two ops computed on the host, against their
    formulas (as tests/test_extensions.py checks the JAX package's)."""
    so = tmp_path / "libtplug.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(so),
                    os.path.join(REPO, "native", "example_plugin.cc")],
                   check=True, capture_output=True, timeout=600)
    names = tmx.library.load(str(so), verbose=False)
    assert names == ["plugin_gelu_tanh", "plugin_mish"]
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    want = {"plugin_gelu_tanh": 0.5 * x * (1 + np.tanh(
        0.7978845608 * (x + 0.044715 * x ** 3))),
        "plugin_mish": x * np.tanh(np.log1p(np.exp(x)))}
    for name in names:
        got = getattr(tmx.nd, name)(tmx.nd.array(x, ctx=CPU)).asnumpy()
        np.testing.assert_allclose(got, want[name], atol=1e-5)


def test_bad_library(tmp_path):
    bad = tmp_path / "x.txt"
    bad.write_text("nope")
    with pytest.raises(MXNetError, match="py or .so"):
        tmx.library.load(str(bad))
    with pytest.raises(MXNetError, match="does not exist"):
        tmx.library.load(str(tmp_path / "missing.py"))


def test_runtime_features():
    feats = tmx.runtime.Features()
    assert feats.is_enabled("cpu") and not feats.is_enabled("no_such")
    assert feats.is_enabled("CUDA") == torch.cuda.is_available()
    assert {"CUDA", "CUDNN", "NCCL", "NVCC", "KERNEL_MATMUL_EPILOGUE",
            "KERNEL_FLASH_ATTENTION"} <= set(feats)
    assert [f.name for f in tmx.runtime.feature_list()] == list(feats)
    assert "CPU" in repr(feats)


def test_name_and_attr_scopes_as_jax():
    from mxnet_tpu.attribute import AttrScope as JScope
    from mxnet_tpu.name import NameManager as JNames, Prefix as JPrefix
    from mxnet_tpu_torch.attribute import AttrScope as TScope
    from mxnet_tpu_torch.name import NameManager as TNames, \
        Prefix as TPrefix

    def names(nm_cls, prefix_cls, current):
        out = []
        with prefix_cls("mynet_"):
            out += [current().get(None, "fc"), current().get(None, "fc"),
                    current().get("given", "fc")]
        with nm_cls():
            out.append(current().get(None, "conv"))
        return out

    import mxnet_tpu.name as jname
    import mxnet_tpu_torch.name as tname
    assert names(TNames, TPrefix, tname.current) == \
        names(JNames, JPrefix, jname.current) == \
        ["mynet_fc0", "mynet_fc1", "mynet_given", "conv0"]

    def attrs(scope, current):
        with scope(ctx_group="dev1", mood="testy"):
            with scope(mood="calm"):
                inner = current().get({"extra": "1"})
            outer = current().get()
        return inner, outer, current().get()

    import mxnet_tpu.attribute as jattr
    import mxnet_tpu_torch.attribute as tattr
    assert attrs(TScope, tattr.current) == attrs(JScope, jattr.current)
    assert tmx.AttrScope is TScope

    def symbols(mx):
        with mx.name.Prefix("blk_"), mx.AttrScope(ctx_group="dev2"):
            fc = mx.sym.FullyConnected(mx.sym.var("x"), num_hidden=2)
        return fc.name, fc.list_arguments(), fc.list_attr()["__ctx_group__"]
    assert symbols(tmx) == symbols(jmx)


def test_util_np_array_scope_as_jax():
    for mx in (tmx, jmx):
        assert not mx.util.is_np_array()
        with mx.util.np_array():
            assert mx.util.is_np_array()
        assert not mx.util.is_np_array()

        @mx.util.use_np
        def inner():
            return mx.util.is_np_array()
        assert inner() and not mx.util.is_np_array()
        mx.util.set_np(shape=False, array=True)
        with mx.util.np_array(False):
            assert not mx.util.is_np_array()
        assert mx.util.is_np_array() and not mx.npx._np_mode["shape"]
        mx.util.reset_np()


def test_use_np_on_class_keeps_class():
    @tmx.util.use_np
    class Probe(tmx.gluon.nn.HybridSequential):
        pass
    assert isinstance(Probe, type)
    assert issubclass(Probe, tmx.gluon.nn.HybridSequential)
    assert isinstance(Probe(), Probe)


def test_util_env():
    tmx.util.setenv("MXTT_PROBE_VAR", 3)
    assert tmx.util.getenv("MXTT_PROBE_VAR") == "3"
    tmx.util.setenv("MXTT_PROBE_VAR", None)
    assert tmx.util.getenv("MXTT_PROBE_VAR") is None


def test_test_utils():
    tu = tmx.test_utils
    tu.set_default_context(CPU)
    try:
        a = tu.rand_ndarray((3, 4))
        assert a.ctx == CPU and a.dtype == np.float32
        assert tu.almost_equal(a, a.asnumpy() + 1e-7)
        tu.assert_almost_equal(a, a.asnumpy())
        with pytest.raises(AssertionError):
            tu.assert_almost_equal(a, a.asnumpy() + 1)
        assert tu.same(a, a.asnumpy())
        rs = tu.rand_ndarray((5, 3), stype="row_sparse", density=0.5)
        assert rs.stype == "row_sparse"
        tu.check_numeric_gradient(lambda x: tmx.nd.tanh(x) * x,
                                  [np.random.RandomState(2).randn(3)
                                   .astype(np.float32)])
        out = tu.check_consistency(lambda x: x * 2, [a],
                                   ctx_list=[CPU, CPU])
        np.testing.assert_allclose(out[0], a.asnumpy() * 2)
        assert tu.list_contexts()[0] == CPU
        assert len(tu.rand_shape_nd(3)) == 3
    finally:
        tu.set_default_context(None)


def test_item6_names_resolve():
    nd = tmx.nd
    for name in ("foreach", "while_loop", "cond"):
        assert callable(getattr(nd.contrib, name))
    for name in ("CSRNDArray", "RowSparseNDArray", "csr_matrix",
                 "row_sparse_array"):
        assert getattr(nd, name) is getattr(nd.sparse, name)
    assert callable(nd.Custom) and callable(nd.op.Custom)
    for mod in ("np", "npx", "operator", "library", "runtime", "name",
                "attribute", "util", "test_utils"):
        assert getattr(tmx, mod) is not None


def test_port_never_imports_jax():
    """No module of the port imports JAX or the JAX package, at the top
    or inside a function (every import statement of every file)."""
    import ast
    root = os.path.join(REPO, "mxnet_tpu_torch")
    bad = []
    for dirpath, _, names in os.walk(root):
        for fname in names:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                mods = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) \
                    and not node.level else []
                bad += [(path, m) for m in mods
                        if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
    assert not bad, bad
