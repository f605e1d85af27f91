"""``metric``, ``metric_det``, ``callback`` and ``observability.metrics``
in the port (mxnet_tpu_torch/) against the JAX package's modules, on
the same seeded numpy inputs: the port is given torch tensors, the JAX
package numpy arrays.

- Every registered metric name and alias, and ``Torch`` and ``Caffe``:
  two updates, then ``get()`` and ``get_name_value()`` equal, float for
  float; the two registries hold the same names.
- ``CompositeEvalMetric``, every form of ``create`` (name, callable,
  list, instance, class), ``np_metric``, ``CustomMetric`` (a number or a
  (sum, count) pair), ``update_dict``; an unknown name raises.
- VOC and VOC07 mAP over seeded boxes, with class names and an IoU
  ladder: equal.
- bf16 predictions: the port casts 16-bit floats to float32 before
  numpy, the JAX package hands numpy ``ml_dtypes.bfloat16`` arrays, so a
  metric that computes in the prediction's dtype (the log of a
  cross-entropy, the sum of ``Loss``) differs in its last bits: within
  1e-2 relative (the bf16 epsilon is 7.8e-3; ``Loss`` here 1.9e-3),
  equal where the metric promotes to float32.
- ``LatencySummary``: 5000 seeded observations (past the 2048-slot
  reservoir) give equal ``summary()`` dicts key for key, and the
  server's request latency is that class, named ``request_latency_ms``.
- ``Counter``, ``Gauge``, labeled ``Summary`` families in a
  ``MetricsRegistry``: equal ``prometheus_text()`` and ``snapshot()``;
  the registry's refusals.
- ``Speedometer``, ``log_train_metric`` and
  ``LogValidationMetricsCallback``: equal log lines with both modules'
  clocks patched; ``do_checkpoint`` writes the epochs the JAX
  package's writes (period, keep_last), files either package reads.
"""
import logging
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import callback as jcallback
from mxnet_tpu import metric as jmetric
from mxnet_tpu.observability import metrics as jobs
from mxnet_tpu_torch import callback as tcallback
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.observability import metrics as tobs

N, C = 64, 5


def _inputs(kind, seed):
    """(labels, preds) numpy float32 of one update of a ``kind`` metric."""
    rng = np.random.RandomState(seed)
    if kind == "class":
        logits = rng.randn(N, C).astype(np.float32)
        p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return rng.randint(0, C, N).astype(np.float32), p.astype(np.float32)
    if kind == "binary":
        p = rng.rand(N).astype(np.float32)
        return (rng.rand(N) > 0.5).astype(np.float32), \
            np.stack([1 - p, p], 1)
    if kind == "binary_1d":
        return (rng.rand(N) > 0.5).astype(np.float32), \
            rng.rand(N).astype(np.float32)
    if kind == "regression":
        y = rng.randn(N).astype(np.float32)
        return y, (y + 0.3 * rng.randn(N)).astype(np.float32)
    return None, rng.rand(N).astype(np.float32)          # "loss"


CASES = [("accuracy", {}, "class"), ("acc", {}, "class"),
         ("top_k_accuracy", {"top_k": 3}, "class"),
         ("top_k_acc", {"top_k": 2}, "class"),
         ("topkaccuracy", {}, "class"),
         ("f1", {}, "binary"), ("f1", {}, "binary_1d"),
         ("mcc", {}, "binary"), ("mcc", {}, "binary_1d"),
         ("mae", {}, "regression"), ("mse", {}, "regression"),
         ("rmse", {}, "regression"),
         ("crossentropy", {}, "class"), ("ce", {"eps": 1e-8}, "class"),
         ("negativeloglikelihood", {}, "class"), ("nll_loss", {}, "class"),
         ("perplexity", {}, "class"),
         ("perplexity", {"ignore_label": 2}, "class"),
         ("pearsoncorrelation", {}, "regression"),
         ("pearson_correlation", {}, "regression"),
         ("loss", {}, "loss")]


def _feed(metric, kind, as_tensor, dtype=None):
    for seed in (0, 1):
        labels, preds = _inputs(kind, seed)
        if as_tensor:
            preds = torch.from_numpy(preds)
            if dtype is not None:
                preds = preds.to(dtype)
            labels = None if labels is None else torch.from_numpy(labels)
        elif dtype is not None:
            preds = jmx.nd.array(preds, dtype=dtype)
        metric.update([labels], [preds])
    return metric


def _equal(got, want):
    np.testing.assert_equal(got.get(), want.get())
    np.testing.assert_equal(got.get_name_value(), want.get_name_value())


def test_registries_hold_the_same_names():
    assert sorted(tmetric._REGISTRY) == sorted(jmetric._REGISTRY)
    assert tmx.metric.VOCMApMetric is tmx.metric_det.VOCMApMetric
    assert tmx.metric.VOC07MApMetric is tmx.metric_det.VOC07MApMetric


@pytest.mark.parametrize("name,kwargs,kind", CASES)
def test_metric_matches_jax(name, kwargs, kind):
    got = _feed(tmetric.create(name, **kwargs), kind, True)
    want = _feed(jmetric.create(name, **kwargs), kind, False)
    assert type(got).__name__ == type(want).__name__
    _equal(got, want)
    got.reset()
    want.reset()
    _equal(got, want)


@pytest.mark.parametrize("cls", ["Torch", "Caffe", "Loss"])
def test_loss_aliases_match_jax(cls):
    _equal(_feed(getattr(tmetric, cls)(), "loss", True),
           _feed(getattr(jmetric, cls)(), "loss", False))


def _feval(label, pred):
    return float(np.abs(label - pred).sum()), len(label)


def _create_forms(mod):
    """Every form of ``create``, and the decorator."""
    forms = [mod.create("acc"), mod.create(mod.MAE), mod.create(mod.MSE()),
             mod.create(["acc", "mae"]), mod.create(_feval, name="l1"),
             mod.np_metric(lambda l, p: float((l == p).mean()),
                           name="same")(),
             mod.CompositeEvalMetric(["rmse", mod.MSE()], name="pair")]
    forms[-1].add("mae")
    return forms


def test_create_composite_and_custom_match_jax():
    got, want = _create_forms(tmetric), _create_forms(jmetric)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        _feed(g, "regression", True)
        _feed(w, "regression", False)
        _equal(g, w)
    assert got[-1].get_metric(2).get() == want[-1].get_metric(2).get()
    for mod in (tmetric, jmetric):
        with pytest.raises(Exception, match="unknown metric"):
            mod.create("no_such_metric")
    labels, preds = _inputs("class", 3)
    g = tmetric.Accuracy(output_names=["out"], label_names=["y"])
    w = jmetric.Accuracy(output_names=["out"], label_names=["y"])
    g.update_dict({"y": torch.from_numpy(labels)},
                  {"out": torch.from_numpy(preds)})
    w.update_dict({"y": labels}, {"out": preds})
    _equal(g, w)


def _boxes(seed, classes=3, images=4):
    """Seeded VOC labels (B, M, 6) and detections (B, N, 6), with padding
    rows (class -1) and difficult flags."""
    rng = np.random.RandomState(seed)
    labels, preds = [], []
    for _ in range(images):
        xy = rng.rand(6, 2) * 50
        gt = np.concatenate([rng.randint(0, classes, (6, 1)), xy,
                             xy + 5 + rng.rand(6, 2) * 20,
                             (rng.rand(6, 1) < 0.15)], 1)
        gt[-1, 0] = -1
        det = np.concatenate([rng.randint(0, classes, (8, 1)),
                              rng.rand(8, 1),
                              np.repeat(gt[:, 1:5], 2, 0)[:8]
                              + rng.randn(8, 4) * 3], 1)
        det[-1, 0] = -1
        labels.append(gt)
        preds.append(det)
    return np.array(labels, np.float32), np.array(preds, np.float32)


@pytest.mark.parametrize("kwargs", [
    {}, {"class_names": ["a", "b", "c", "d"]},
    {"iou_thresh": [0.5, 0.6, 0.75]}])
@pytest.mark.parametrize("cls", ["VOCMApMetric", "VOC07MApMetric"])
def test_voc_map_matches_jax(cls, kwargs):
    got = getattr(tmx.metric, cls)(**kwargs)
    want = getattr(jmx.metric, cls)(**kwargs)
    for seed in (0, 1):
        labels, preds = _boxes(seed)
        got.update(torch.from_numpy(labels), torch.from_numpy(preds))
        want.update(labels, preds)
    np.testing.assert_equal(got.get(), want.get())
    assert np.isfinite(got.get()[1]).any()


@pytest.mark.parametrize("name,kind,tol", [
    ("acc", "class", 0.0), ("top_k_acc", "class", 0.0),
    ("mse", "regression", 0.0), ("mae", "regression", 0.0),
    ("ce", "class", 1e-2), ("perplexity", "class", 1e-2),
    ("loss", "loss", 1e-2)])
def test_bf16_predictions_within_tolerance(name, kind, tol):
    got = _feed(tmetric.create(name), kind, True, torch.bfloat16)
    want = _feed(jmetric.create(name), kind, False, "bfloat16")
    g, w = got.get()[1], want.get()[1]
    assert abs(g - w) <= tol * abs(w), (g, w)


def test_latency_summary_matches_jax_over_5000_observations():
    rng = np.random.RandomState(0)
    values = rng.lognormal(1.0, 0.75, 5000)
    got, want = tobs.LatencySummary("request_latency_ms"), \
        jobs.LatencySummary("request_latency_ms")
    assert got.summary() == want.summary()
    for v in values:
        got.observe(v)
        want.observe(v)
    assert got.summary() == want.summary()
    assert list(got.summary()) == list(want.summary())
    assert got.get() == want.get()
    assert (got.count, got.sum) == (want.count, want.sum)
    assert got.percentile(90) == want.percentile(90)
    other = tobs.LatencySummary(rng=random.Random(1))
    for v in values:
        other.observe(v)
    assert other.summary()["p50"] != got.summary()["p50"]
    server = tmx.serving.Server(tmx.gluon.nn.Activation("relu"),
                                ctx=tmx.cpu())
    assert isinstance(server.latency, tmetric.LatencySummary)
    assert server.latency.name == "request_latency_ms"
    with pytest.raises(MXNetError):
        tobs.LatencySummary(reservoir_size=0)


def _fill(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("steps_total", "steps taken")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("queue_depth", "requests\nwaiting", ("server",))
    g.labels(server="a").set(3)
    g.labels(server='b"x').inc(1.25)
    g.labels(server="a").dec()
    s = reg.summary("latency_ms", "", ("phase",))
    rng = np.random.RandomState(2)
    for v in rng.rand(300):
        s.labels(phase="fwd").observe(v)
    reg.summary("empty_ms").labels()
    assert reg.counter("steps_total") is c
    return reg


def test_registry_prometheus_text_matches_jax():
    got, want = _fill(tobs), _fill(jobs)
    assert got.prometheus_text() == want.prometheus_text()
    assert got.snapshot() == want.snapshot()
    for mod in (tobs, jobs):
        reg = mod.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(Exception, match="already registered"):
            reg.gauge("x")
        with pytest.raises(Exception, match="invalid metric name"):
            reg.counter("1x")
        with pytest.raises(Exception, match="backwards"):
            reg.counter("x").set(-1)
    tobs.reset_metrics().counter("port_only").inc()
    assert "port_only 1" in tobs.prometheus_text()
    assert tobs.snapshot()["port_only"]["type"] == "counter"
    assert tmx.observability.default_registry() is \
        tobs.default_registry()


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        self.t += 0.5
        return self.t


class _Param:
    def __init__(self, epoch, nbatch, eval_metric):
        self.epoch, self.nbatch, self.eval_metric = epoch, nbatch, \
            eval_metric


def _callback_lines(cb_mod, metric_mod, caplog, monkeypatch, as_tensor):
    monkeypatch.setattr(cb_mod, "time", _Clock())
    caplog.clear()
    metric = metric_mod.create(["acc", "ce"])
    speed = cb_mod.Speedometer(batch_size=32, frequent=2)
    log_train = cb_mod.log_train_metric(2)
    bare = cb_mod.Speedometer(batch_size=8, frequent=3, auto_reset=False)
    with caplog.at_level(logging.INFO):
        for nbatch in range(7):
            _feed(metric, "class", as_tensor)
            speed(_Param(1, nbatch, metric))
            log_train(_Param(1, nbatch, metric))
            bare(_Param(0, nbatch, None))
        cb_mod.LogValidationMetricsCallback()(_Param(1, 7, metric))
    return [r.getMessage() for r in caplog.records]


def _checkpoints(mx, cb_mod, prefix):
    """Epochs 0-5 through ``do_checkpoint(period=2, keep_last=2)``: the
    epoch files left, and the parameters of each as numpy."""
    sym = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2,
                                name="fc")
    callback = cb_mod.do_checkpoint(prefix, period=2, keep_last=2)
    kw = {"ctx": tmx.cpu()} if mx is tmx else {}
    for epoch in range(6):
        w = mx.nd.array(np.full((2, 3), epoch, np.float32), **kw)
        callback(epoch, sym, {"fc_weight": w, "fc_bias": w[0]}, {})
    epochs = mx.model.list_checkpoint_epochs(prefix)
    return epochs, [{k: v.asnumpy() for k, v in
                     mx.model.load_params(prefix, e)[0].items()}
                    for e in epochs]


def test_callbacks_log_the_same_lines(caplog, monkeypatch, tmp_path):
    got = _callback_lines(tcallback, tmetric, caplog, monkeypatch, True)
    want = _callback_lines(jcallback, jmetric, caplog, monkeypatch, False)
    assert got == want
    assert any("samples/sec" in line for line in got)
    t_epochs, t_params = _checkpoints(tmx, tcallback, str(tmp_path / "t"))
    j_epochs, j_params = _checkpoints(jmx, jcallback, str(tmp_path / "j"))
    assert t_epochs == j_epochs == [4, 6]
    for t, j in zip(t_params, j_params):
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
    # each package reads the other's files
    jsym = jmx.model.load_checkpoint(str(tmp_path / "t"), 6)[0]
    tsym = tmx.model.load_checkpoint(str(tmp_path / "j"), 6)[0]
    assert jsym.list_arguments() == tsym.list_arguments()
    assert tcallback.module_checkpoint is tcallback.do_checkpoint
