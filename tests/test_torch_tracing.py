"""The port's tracer (``repro_torch.tracing``) and the spans it
places, on the CPU.

Off, ``span()`` hands out one shared object that records nothing and
opens no profiler range.  Between ``start()`` and ``stop()``, or while a
``torch.profiler`` session records, spans nest by a stack kept per thread
and carry their attributes; under the profiler each also lands in the
trace as a ``repro_torch.<name>`` range.  Then the spans a tiny serving
engine and a tiny train step leave, parent by parent, and the kernels'
autograd Functions' backward spans with their launches stubbed by the
plain forward (on the card: ``tests/test_torch_gpu.py``).
"""

import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import flash_attention_ref, ssd_ref
from repro_torch.kernels.substrate import KernelFunction
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, get_config
from repro_torch.optim import AdamWConfig, init_state
from repro_torch import tracing
from repro_torch.serving import Request, ServingEngine

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=128, remat=False, q_chunk=32,
             loss_seq_chunk=None)


@pytest.fixture(autouse=True)
def fresh():
    tracing.stop()
    tracing.clear()
    yield
    tracing.stop()
    tracing.clear()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def _parent(recs, rec):
    return next(r for r in recs if r["id"] == rec["parent"])


def test_off_span_is_one_shared_object_that_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("opened while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing.time, "perf_counter_ns", refuse)
    a = tracing.span("a")
    b = tracing.span("b", device=True, rows=3)
    assert a is b
    with a as sp:
        with b:
            sp.set(n=1)
    assert tracing.spans() == []


def test_start_records_nesting_parents_attributes_and_thread_roots():
    tracing.start()
    seen = {}

    def other():
        with tracing.span("elsewhere"):
            seen["thread"] = threading.get_ident()

    with tracing.span("outer", rid=7) as sp:
        with tracing.span("inner", rows=2):
            pass
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        sp.set(admitted=1)
    tracing.stop()
    with tracing.span("after"):
        pass
    recs = _by_name(tracing.spans())
    assert set(recs) == {"outer", "inner", "elsewhere"}
    (outer,), (inner,), (other_rec,) = (recs["outer"], recs["inner"],
                                        recs["elsewhere"])
    assert outer["parent"] is None and inner["parent"] == outer["id"]
    assert outer["attrs"] == {"rid": 7, "admitted": 1}
    assert inner["attrs"] == {"rows": 2}
    assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] <= \
        outer["t1_ns"]
    assert outer["thread"] == inner["thread"] == threading.get_ident()
    # a span opened on another thread has no parent from this one
    assert other_rec["parent"] is None
    assert other_rec["thread"] == seen["thread"] != outer["thread"]
    assert all(r["device_s"] is None for r in tracing.spans())


def test_profiler_turns_spans_on_and_puts_them_in_its_trace(tmp_path):
    assert tracing.span("x") is tracing.span("y")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("pb:outer"):
            with tracing.span("layer", tokens=4):
                torch.ones(4).add_(1)
    assert tracing.span("x") is tracing.span("y")
    (rec,) = tracing.spans()
    assert rec["name"] == "layer" and rec["attrs"] == {"tokens": 4}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (outer,) = [e for e in events if e["name"] == "pb:outer"]
    (inner,) = [e for e in events if e["name"] == "repro_torch.layer"]
    assert inner["tid"] == outer["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_the_buffer_keeps_the_newest_spans_up_to_its_capacity():
    tracing.start()
    for i in range(tracing.CAPACITY + 10):
        with tracing.span("s", i=i):
            pass
    recs = tracing.spans()
    assert len(recs) == tracing.CAPACITY
    assert recs[0]["attrs"]["i"] == 10
    assert recs[-1]["attrs"]["i"] == tracing.CAPACITY + 9
    tracing.clear()
    assert tracing.spans() == []


@pytest.fixture(scope="module")
def small_lm():
    model = build_model(get_config("granite-8b").replace(**SMALL),
                        device="cpu")
    return model, model.init(seed=0, dtype=torch.float32)


def _chain(recs, rec):
    """Names from ``rec`` up to its root."""
    names = [rec["name"]]
    while rec["parent"] is not None:
        rec = _parent(recs, rec)
        names.append(rec["name"])
    return names


@pytest.mark.parametrize("buckets", [None, "auto"], ids=["exact", "bucketed"])
def test_engine_spans(small_lm, buckets):
    model, params = small_lm
    eng = ServingEngine(model, params, width=2, max_len=32,
                        prompt_buckets=buckets)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, n) for n in (6, 4, 5)]
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    tracing.start()
    done = eng.run()
    tracing.stop()
    assert len(done) == 3
    recs = tracing.spans()
    by = _by_name(recs)
    steps = by["engine.step"]
    assert all(r["parent"] is None for r in steps)
    assert sum(r["attrs"]["admitted"] for r in steps) == 3
    assert steps[0]["attrs"] == {"admitted": 2, "rows": 2}
    for r in by["kernel.flash_attention"]:
        assert _chain(recs, r) == ["kernel.flash_attention", "step.prefill",
                                   "engine.admit", "engine.step"]
    for r in by["kernel.decode_attention"]:
        assert _chain(recs, r) == ["kernel.decode_attention", "step.decode",
                                   "engine.step"]
    assert len(by["kernel.flash_attention"]) == \
        SMALL["n_layers"] * len(by["step.prefill"])
    assert len(by["kernel.decode_attention"]) == \
        SMALL["n_layers"] * len(by["step.decode"])
    # on the CPU the decode step runs eagerly, never as a graph replay
    assert all(r["attrs"] == {"graphed": False} for r in by["step.decode"])
    assert all(r["attrs"] == {} for r in by["step.prefill"])
    for r in by["engine.readback"]:
        assert _parent(recs, r)["name"] == "engine.step"
        assert r["attrs"] == {}
    assert len(by["engine.readback"]) == len(by["step.decode"])
    admits = by["engine.admit"]
    if buckets is None:
        assert sorted((r["attrs"]["rid"], r["attrs"]["prompt_tokens"])
                      for r in admits) == [(0, 6), (1, 4), (2, 5)]
    else:
        assert [r["attrs"]["rids"] for r in admits] == [[0, 1], [2]]
        assert [r["attrs"]["prompt_tokens"] for r in admits] == [10, 5]
        # the rows each prefill ran (the requests it admitted) times its
        # bucket: the longest prompt but its last token, 5 and 4, both in
        # the smallest bucket
        bucket = min(eng.prompt_buckets)
        assert [r["attrs"]["rows"] for r in admits] == [2, 1]
        assert [r["attrs"]["padded_tokens"] for r in admits] == \
            [2 * bucket, 1 * bucket]


def test_train_step_spans(small_lm):
    model, params = small_lm
    params = {**params}
    step = make_train_step(model, AdamWConfig())
    opt = init_state(params)
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 128, (2, 17)).astype(np.int32))
    batch = {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:]}
    tracing.start()
    step(params, opt, batch)
    tracing.stop()
    recs = tracing.spans()
    by = _by_name(recs)
    (root,) = by["step.train"]
    assert root["parent"] is None and root["attrs"] == {}
    for name in ("train.forward", "train.backward", "train.optimizer"):
        (r,) = by[name]
        assert r["parent"] == root["id"] and r["attrs"] == {}
        assert r["device_s"] is None            # no CUDA events on the CPU
    fwd, bwd, opt_span = (by[n][0] for n in ("train.forward",
                                              "train.backward",
                                              "train.optimizer"))
    assert fwd["t1_ns"] <= bwd["t0_ns"] and bwd["t1_ns"] <= opt_span["t0_ns"]
    assert [_chain(recs, r)[1:] for r in by["kernel.flash_attention"]] == \
        [["train.forward", "step.train"]] * SMALL["n_layers"]


@pytest.fixture
def plain_launches(monkeypatch):
    """Each wrapper's ``_launch`` replaced by its plain forward, so that
    the Function runs on the CPU as it does on the card."""
    monkeypatch.setattr(
        fa_mod, "_launch", lambda q, k, v, causal, window, softcap, bq, bk:
        flash_attention_ref(q, k, v, causal=causal, window=window,
                            softcap=softcap))
    monkeypatch.setattr(ssd_mod, "_launch", lambda x, la, b, c, chunk:
                        ssd_ref(x, la, b, c, chunk=chunk))


def _flash_grads():
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 6, 2, 8, generator=g).requires_grad_()
               for _ in range(3))
    o = KernelFunction.apply(
        "flash_attention",
        lambda *t: fa_mod._launch(*t, True, None, None, None, None),
        lambda *t: flash_attention_ref(*t, causal=True), q, k, v)
    torch.autograd.grad(o.sum(), (q, k, v))


def _ssd_grads():
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 8, 2, 4, generator=g).requires_grad_()
    la = (-torch.rand(1, 8, 2, generator=g)).requires_grad_()
    b, c = (torch.randn(1, 8, 2, 2, generator=g).requires_grad_()
            for _ in range(2))
    y, final = KernelFunction.apply(
        "ssd_scan", lambda *t: ssd_mod._launch(*t, 4),
        lambda *t: ssd_ref(*t, chunk=4), x, la, b, c)
    torch.autograd.grad(y.sum() + final.sum(), (x, la, b, c))


@pytest.mark.parametrize("name,run", [
    ("kernel.flash_attention.backward", _flash_grads),
    ("kernel.ssd_scan.backward", _ssd_grads)], ids=["flash", "ssd"])
def test_function_backward_spans(plain_launches, name, run):
    tracing.start()
    run()
    tracing.stop()
    (rec,) = tracing.spans()
    assert rec["name"] == name and rec["parent"] is None
    assert rec["device_s"] is None and rec["t1_ns"] > rec["t0_ns"]
