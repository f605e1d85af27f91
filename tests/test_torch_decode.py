"""The port's continuous-batching decode engine
(mxnet_tpu_torch/serving/decode.py) against the JAX package's on the CPU.

- ``TinyLM.prefill_fn`` and ``step_fn`` on seeded int32 states give the
  arrays of the JAX package's jitted functions bit for bit, the dropped
  writes included: a padded chunk tail, a chunk running past the row, an
  inactive slot, an active slot at ``pos == max_len`` (the port masks
  these writes; the reference drops out-of-range scatter indices).
- The same seeded prompts through both engines give identical tokens,
  both ``TinyLM.reference``'s, with equal schedule-independent counters
  (``compiles``, ``programs``, ``admitted``, ``completed``,
  ``tokens_out``).
- Refusals and failures by class and ``retryable``: an oversized prompt,
  ``SlotsExhausted`` with ``queue_on_busy=False``, a cancel before and
  after admission, a deadline miss.
- ``Server(decode_model=)``: ``decode`` beside ``predict``, ``beacon()``'s
  keys, ``summary()``'s keys, and ``decode_submit`` without a model.
On the card the engine's programs are CUDA graphs
(``tests/test_torch_cuda.py``).
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.serving import DeadlineExceeded as JDeadline
from mxnet_tpu.serving import RequestError as JRequestError
from mxnet_tpu.serving import Server as JServer
from mxnet_tpu.serving import ServerConfig as JServerConfig
from mxnet_tpu.serving import SlotsExhausted as JSlots
from mxnet_tpu.serving import decode as jdec
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.serving import (DeadlineExceeded, RequestError, Server,
                                     ServerConfig, SlotsExhausted, decode)

MAX_LEN = 24


@pytest.fixture(autouse=True)
def quiet_journals(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_JOURNAL", "off")
    from mxnet_tpu.diagnostics.journal import reset_journal as jreset
    from mxnet_tpu_torch.diagnostics.journal import reset_journal as treset
    jreset("off")
    treset("off")
    yield
    jreset()
    treset()


def _state(seed, slots=4, max_len=MAX_LEN, vocab=251):
    rng = np.random.RandomState(seed)
    return {"pos": rng.randint(0, max_len + 1, slots).astype(np.int32),
            "acc": rng.randint(0, vocab, slots).astype(np.int32),
            "kv": rng.randint(0, vocab, (slots, max_len)).astype(np.int32)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _equal(got, want):
    for k in want:
        g = got[k].numpy()
        assert g.dtype == np.int32, k
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


# (slot, chunk, length, start): fresh, continued, padded tail, past the
# row's end, empty chunk
PREFILL_CASES = [(0, 8, 8, 0), (1, 8, 5, 0), (2, 4, 3, 6), (3, 8, 8, 20),
                 (1, 4, 0, 0), (2, 16, 13, 9)]


@pytest.mark.parametrize("slot,chunk,length,start", PREFILL_CASES)
def test_tinylm_prefill_bit_equal(slot, chunk, length, start):
    jm, tm = jdec.TinyLM(max_len=MAX_LEN), decode.TinyLM(max_len=MAX_LEN)
    st = _state(seed=slot * 10 + chunk + start)
    toks = np.random.RandomState(length).randint(0, 251, chunk).astype(
        np.int32)
    args = (np.int32(slot), toks, np.int32(length), np.int32(start))
    want = jax.jit(jm.prefill_fn)(st, *args)
    got = tm.prefill_fn(_torch(st), *(torch.tensor(a) for a in args))
    _equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_tinylm_step_bit_equal(seed):
    jm, tm = jdec.TinyLM(max_len=MAX_LEN), decode.TinyLM(max_len=MAX_LEN)
    st = _state(seed=100 + seed, slots=6)
    st["pos"][0] = MAX_LEN           # an active slot with a full row
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 251, (6, 1)).astype(np.int32)
    active = rng.rand(6) < 0.6
    active[0] = True
    active[1] = False                # an inactive slot
    want_st, want_nxt = jax.jit(jm.step_fn)(st, toks, active)
    got_st, got_nxt = tm.step_fn(_torch(st), torch.from_numpy(toks),
                                 torch.from_numpy(active))
    _equal(got_st, want_st)
    assert got_nxt.dtype == torch.int32
    np.testing.assert_array_equal(got_nxt.numpy(), np.asarray(want_nxt))


def _engine(pkg, slots=4, model_kw=None, **cfg):
    cfg.setdefault("window_ms", 1.0)
    mod = jdec if pkg == "jax" else decode
    kw = {} if pkg == "jax" else {"ctx": tmx.cpu()}
    eng = mod.DecodeEngine(mod.TinyLM(**(model_kw or {})),
                           mod.DecodeConfig(slots=slots, **cfg), **kw)
    eng.start()
    eng.warmup()
    return eng


def _engines(slots=4, model_kw=None, **cfg):
    return (_engine("jax", slots, model_kw, **cfg),
            _engine("port", slots, model_kw, **cfg))


def _wait(cond, timeout_s=30.0):
    t_end = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < t_end, "timed out"
        time.sleep(0.002)


COUNTERS = ("compiles", "programs", "admitted", "completed", "tokens_out",
            "submitted", "rejected", "cancelled", "preempted")


def test_engine_streams_match_jax_engine():
    rng = np.random.RandomState(7)
    specs = []
    for _ in range(12):
        n_prompt = int(rng.randint(1, 60))
        specs.append((rng.randint(0, 251, n_prompt).tolist(),
                      int(rng.randint(1, 30))))
    je, te = _engines(slots=4, prefill_chunk=16)
    try:
        outs = {}
        for name, eng in (("jax", je), ("port", te)):
            streams = [eng.submit(p, max_new_tokens=n) for p, n in specs]
            outs[name] = [s.result(60) for s in streams]
        ref = [te.model.reference(p, n) for p, n in specs]
        assert outs["port"] == outs["jax"] == ref
        js, ts = je.stats(), te.stats()
        assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
        assert ts["compiles"] == 1 + len(te.prefill_buckets) == 6
        assert ts["grid_bound"] == js["grid_bound"] == 1
    finally:
        je.stop()
        te.stop()


def test_oversized_prompt_rejected_alike():
    je, te = _engines(slots=2)
    try:
        for eng, err in ((je, JRequestError), (te, RequestError)):
            with pytest.raises(err) as ei:
                eng.submit(list(range(250)), max_new_tokens=10)
            assert ei.value.retryable is False
            with pytest.raises(err):
                eng.submit([], max_new_tokens=1)
        assert te.stats()["rejected"] == je.stats()["rejected"] == 2
    finally:
        je.stop()
        te.stop()


def test_slots_exhausted_and_cancels_alike():
    """One slot held by a long stream: ``queue_on_busy=False`` bounces a
    second stream with a retryable ``SlotsExhausted``; a queued stream
    cancelled before admission and the held one cancelled mid-decode end
    in non-retryable ``RequestError``s; the next stream is exact."""
    kw = {"model_kw": {"max_len": 20000}}
    outcomes = {}
    for name, slots_err in (("jax", JSlots), ("port", SlotsExhausted)):
        eng = _engine(name, slots=1, **kw)
        try:
            held = eng.submit([1, 2, 3], max_new_tokens=15000)
            _wait(lambda: eng.occupancy() == 1 and len(held.tokens) > 2)
            queued = eng.submit([4, 5], max_new_tokens=3)
            queued.cancel()
            eng.config.queue_on_busy = False
            with pytest.raises(slots_err) as ei:
                eng.submit([6, 7], max_new_tokens=3)
            bounced = (type(ei.value).__name__, ei.value.retryable,
                       ei.value.slots)
            held.cancel()
            res = []
            for s in (held, queued):
                with pytest.raises(Exception) as ex:
                    s.result(60)
                res.append((type(ex.value).__name__, ex.value.retryable,
                            str(ex.value).split(" after")[0]))
            eng.config.queue_on_busy = True
            assert eng.generate([9, 8], max_new_tokens=5) == \
                eng.model.reference([9, 8], 5)
            st = eng.stats()
            outcomes[name] = (bounced, res, st["cancelled"], st["shed"])
        finally:
            eng.stop()
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == ("SlotsExhausted", True, 1)
    assert outcomes["port"][2:] == (2, 1)


def test_deadline_miss_alike():
    kw = {"model_kw": {"max_len": 20000}}
    got = {}
    for name, dl_err in (("jax", JDeadline), ("port", DeadlineExceeded)):
        eng = _engine(name, slots=1, **kw)
        try:
            held = eng.submit([1, 2], max_new_tokens=15000)
            _wait(lambda: eng.occupancy() == 1)
            late = eng.submit([3, 4], max_new_tokens=4, deadline_ms=5)
            time.sleep(0.05)
            held.cancel()
            with pytest.raises(dl_err) as ei:
                late.result(60)
            # a stream preempted mid-decode by its deadline
            mid = eng.submit([5], max_new_tokens=15000, deadline_ms=50)
            with pytest.raises(dl_err) as ej:
                mid.result(60)
            got[name] = (ei.value.stage, ei.value.retryable, ej.value.stage,
                         eng.stats()["preempted"])
        finally:
            eng.stop()
    assert got["port"] == got["jax"] == ("decode_admit", False,
                                         "decode_step", 2)


def _jax_dense():
    net = jnn.Dense(4, in_units=4)
    net.initialize()
    return net


def _port_dense():
    net = tnn.Dense(4, in_units=4)
    net.initialize(ctx=tmx.cpu(), generator=tmx.random.generator(0))
    return net


def test_server_decode_beacon_and_refusals():
    model = decode.TinyLM()
    jsrv = JServer(_jax_dense(), config=JServerConfig(window_ms=1.0)).start()
    tsrv = Server(_port_dense(), ServerConfig(
        window_ms=1.0, decode_model=model,
        decode=decode.DecodeConfig(slots=2, window_ms=1.0)),
        ctx=tmx.cpu()).start()
    plain = Server(_port_dense(), ServerConfig(window_ms=1.0),
                   ctx=tmx.cpu()).start()
    try:
        assert set(tsrv.beacon()) == set(jsrv.beacon())
        assert tsrv.beacon()["ready"] is True
        assert set(tsrv.config.summary()) == set(jsrv.config.summary())
        assert tsrv.config.summary()["decode"] == "TinyLM"
        assert tsrv.stats()["decode"]["compiles"] == 7
        results = {}

        def stream(i):
            p = [i + 1, i + 2, i + 3]
            results[i] = tsrv.decode(p, max_new_tokens=6 + i)

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        y = tsrv.predict(np.ones(4, np.float32))
        for t in threads:
            t.join(60)
        assert y.shape == (4,)
        assert all(results[i] == model.reference([i + 1, i + 2, i + 3],
                                                 6 + i) for i in range(4))
        errs = []
        for srv, err in ((jsrv, JRequestError), (plain, RequestError)):
            with pytest.raises(err) as ei:
                srv.decode([1], max_new_tokens=2)
            errs.append((type(ei.value).__name__, ei.value.retryable))
        assert errs[0] == errs[1] == ("RequestError", False)
        with pytest.raises(RequestError, match="single-tenant"):
            plain.submit(np.ones(4, np.float32), tenant="a")
    finally:
        jsrv.stop()
        tsrv.stop()
        plain.stop()
    assert tsrv.beacon()["ready"] is False
