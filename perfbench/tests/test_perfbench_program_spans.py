"""The readers of the ``program_span`` metrics that read the port's
tracer, on synthetic records: the spans inside the window are read, those
outside it are left out, and a reader returns None with no peak, with no
span and with a program that has no tracer."""

import sys

import pytest
from harness import files

from repro_torch import tracing

WINDOW = (100.0, 110.0)
HOST = {"decode_dispatch_ms": ("step.decode", 1e3),
        "decode_readback_ms": ("engine.readback", 1e3),
        "admit_ms": ("engine.admit", 1e3),
        "decode_attention_host_us": ("kernel.decode_attention", 1e6)}
DEVICE = {"forward_ms": "train.forward",
          "backward_ms": "train.backward",
          "flash_attention_backward_ms": "kernel.flash_attention.backward",
          "ssd_scan_backward_ms": "kernel.ssd_scan.backward"}
SPANS = {**{m: n for m, (n, _) in HOST.items()}, **DEVICE}


def _span(name, t0_s, host_ms, device_ms=None):
    t0 = int(t0_s * 1e9)
    return {"name": name, "id": 0, "parent": None, "thread": 0,
            "t0_ns": t0, "t1_ns": t0 + int(host_ms * 1e6), "attrs": {},
            "device_s": None if device_ms is None else device_ms / 1e3}


def _spans(name):
    """Three spans of ``name`` inside the window (host 1, 2, 4 ms; device
    1, 2, 6 ms), one before it, one across its close, and another name."""
    return [_span(name, 99.0, 500.0, 500.0),
            _span(name, 101.0, 1.0, 1.0),
            _span(name, 102.0, 4.0, 6.0),
            _span("other", 103.0, 900.0, 900.0),
            _span(name, 104.0, 2.0, 2.0),
            _span(name, 109.999, 50.0, 50.0)]


def _record(peak=(989e12, 3.35e12)):
    return {"window": WINDOW, "peak": peak}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_reads_the_spans_inside_the_window(metric, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: _spans(SPANS[metric]))
    got = files.metric_module(metric).read(_record())
    if metric in HOST:
        assert got == pytest.approx(2.0e-3 * HOST[metric][1])
    else:
        assert got == pytest.approx(3.0)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_gives_none_with_no_peak_or_no_span(metric, monkeypatch):
    reader = files.metric_module(metric).read
    monkeypatch.setattr(tracing, "spans", lambda: _spans(SPANS[metric]))
    assert reader(_record(peak=None)) is None
    # only spans outside the window, or of other names
    monkeypatch.setattr(tracing, "spans", lambda: [
        s for s in _spans(SPANS[metric])
        if not WINDOW[0] * 1e9 <= s["t0_ns"] <= s["t1_ns"] <= WINDOW[1] * 1e9
        or s["name"] == "other"])
    assert reader(_record()) is None
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert reader(_record()) is None


def test_device_readers_skip_spans_without_cuda_events(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: [
        _span("train.forward", 101.0, 3.0), _span("train.forward", 102.0,
                                                  3.0, 8.0)])
    assert files.metric_module("forward_ms").read(_record()) == \
        pytest.approx(8.0)
    monkeypatch.setattr(tracing, "spans", lambda: [
        _span("train.forward", 101.0, 3.0)])
    assert files.metric_module("forward_ms").read(_record()) is None


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_of_a_program_without_the_tracer_gives_none(metric,
                                                           monkeypatch):
    reader = files.metric_module(metric).read
    # as in a checkout whose port has no repro_torch.tracing
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "tracing")
    assert reader(_record()) is None
