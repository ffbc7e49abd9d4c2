"""Spans at the port's layer boundaries, kept in memory.

:func:`span` opens one named span as a context manager::

    with tracing.span("engine.admit", rid=req.rid) as sp:
        ...
        sp.set(prompt_tokens=n)

Tracing is on while a ``torch.profiler`` session records, or between
:func:`start` and :func:`stop`.  Off, :func:`span` hands out one shared
object that records nothing: it reads no clock and opens no profiler
range, so a span on the hot path costs two flag reads.  On, a span records
its name, its own id and its parent's (from a stack kept per thread, so
autograd's device thread has roots of its own), the thread, ``t0_ns`` and
``t1_ns`` from ``time.perf_counter_ns()`` and its attributes.  A span with
``device=True`` also records a CUDA event pair on the current stream;
:func:`spans` turns the pairs into ``device_s`` when it is read, after one
synchronize, never inside the traced loop.  While a profiler records, each
span also opens ``torch.profiler.record_function("repro_torch.<name>")``,
so that it lands on the profiler's clock over the operations launched
inside it.  (A span's host times are not on that clock: the profiler's
trace counts from another origin.)  With CUDA activity on, the profiler
also copies each range onto the device's timeline as a user annotation
(``FunctionEvent.is_user_annotation``); code that sums device events
leaves those out, as it does the harness's own ``record_function`` ranges.

This is a leaf module that imports torch alone, so every layer of the
port, the kernels included, can import it.

The spans live in a buffer of :data:`CAPACITY` records, the oldest
dropped first.  :func:`spans` reads them, :func:`clear` empties it.

Counters are always on: :func:`count` adds to a named total (one dict
update), :func:`counters` reads the totals.  They count the calls that run
Python, so a CUDA graph's replays add nothing; a reader takes the
difference of two readings.  The port's counters: the kernels' launches
``flash_attention_launches``, ``decode_attention_launches``,
``ssd_scan_launches`` (``ssd_scan_wide_launches`` of them on the wide
route) and ``ssd_decode_launches``; their plain backwards
``flash_attention_backward_launches`` and ``ssd_scan_backward_launches``
(``kernels/substrate.py``); ``decode_graph_captures`` and
``decode_graph_replays`` (``launch/steps.py``); ``shared_applications``
(the published Zamba2 blocks' applications, ``models/lm.py``) and
``ssd_pad_positions`` (the identity steps that pad an SSD call's last
chunk, ``kernels/ssd_scan.py``).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["CAPACITY", "PREFIX", "clear", "count", "counters", "span",
           "spans", "start", "stop"]

CAPACITY = 1 << 15
PREFIX = "repro_torch."

_on = False
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_counts: collections.Counter = collections.Counter()


class _Off:
    """The span handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("rec", "_device", "_range", "_events")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.rec = {"name": name, "id": next(_ids), "parent": None,
                    "thread": threading.get_ident(), "t0_ns": 0,
                    "t1_ns": 0, "attrs": attrs, "device_s": None}
        self._device = device
        self._range = None
        self._events = None

    def __enter__(self):
        stack = _stack()
        if stack:
            self.rec["parent"] = stack[-1]
        stack.append(self.rec["id"])
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(
                PREFIX + self.rec["name"])
            self._range.__enter__()
        if self._device:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.rec["t0_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec["t1_ns"] = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
            self.rec["_events"] = self._events
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        _buffer.append(self.rec)
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (counts at its end)."""
        self.rec["attrs"].update(attrs)


def span(name: str, *, device: bool = False, **attrs):
    """A context manager that records one span while tracing is on.
    ``device=True`` adds a CUDA event pair: pass it only for work launched
    on the current CUDA device."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, attrs)


def start() -> None:
    """Record spans until :func:`stop`, with no profiler running."""
    global _on
    _on = True


def stop() -> None:
    global _on
    _on = False


def clear() -> None:
    _buffer.clear()


def spans() -> list[dict]:
    """The finished spans in the buffer, oldest first: ``name``, ``id``,
    ``parent`` (None for a root of its thread), ``thread``, ``t0_ns``,
    ``t1_ns``, ``attrs`` and ``device_s`` (None without CUDA events)."""
    recs = list(_buffer)
    pending = [r for r in recs if "_events" in r]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            events = r.pop("_events", None)     # another reader took it
            if events is not None:
                r["device_s"] = events[0].elapsed_time(events[1]) / 1e3
    return recs


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counters() -> collections.Counter:
    """The counters' totals since the process started, 0 for a counter
    never counted."""
    return collections.Counter(_counts)
