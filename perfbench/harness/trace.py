"""Spans around the calls into each layer, and the reading of a profiler
trace of a short steady sub-window of a traced run.

:class:`Spans` wraps a callable: each call runs inside a
``torch.profiler.record_function`` range named ``pb:<layer>:<index>`` and
leaves a record (host times, CUDA events where asked, the work the call's
shapes need).  :class:`Profile` traces a sub-window with
``torch.profiler`` and attributes device time to each range through the
profiler's launch correlation: a device operation belongs to every range
that was open on the launching thread when the CUDA API call that
launched it ran.  Nothing is matched by kernel name.  A range whose calls
launched no device operation the trace saw gets no device time, and the
metrics that read it report nothing.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "pb:traced_window"


class Spans:
    """Records of the wrapped calls, by layer name."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.calls: dict[str, list] = defaultdict(list)
        self.profiling = False

    def wrap(self, name, fn, *, work=None, events=False, extra=None):
        """``fn`` inside a ``pb:<name>:<i>`` range.  ``work(args, kwargs,
        out)`` returns fields of the call's record (FLOPs, bytes, counts;
        it must not wait for the device); ``events`` puts CUDA events
        around the call; ``extra()`` adds fields read before the call."""
        calls = self.calls[name]

        def wrapped(*args, **kwargs):
            rec = {"label": f"pb:{name}:{len(calls)}",
                   "profiled": self.profiling}
            if extra is not None:
                rec.update(extra())
            start = end = None
            if events and self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            rec["t0"] = time.perf_counter()
            with torch.profiler.record_function(rec["label"]):
                out = fn(*args, **kwargs)
            rec["t1"] = time.perf_counter()
            if start is not None:
                end.record()
                rec["events"] = (start, end)
            if work is not None:
                rec.update(work(args, kwargs, out))
            calls.append(rec)
            return out

        return wrapped

    def resolve(self) -> None:
        """Turn each call's CUDA events into ``event_s`` (waits for the
        device)."""
        if self.cuda:
            torch.cuda.synchronize()
        for recs in self.calls.values():
            for rec in recs:
                ev = rec.pop("events", None)
                if ev is not None:
                    rec["event_s"] = ev[0].elapsed_time(ev[1]) / 1e3


@contextlib.contextmanager
def patched(module, attr: str, value):
    """``module.attr`` replaced by ``value`` for the block."""
    old = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, old)


class Profile:
    """A ``torch.profiler`` session over a sub-window, started and stopped
    by the path's loop."""

    def __init__(self, spans: Spans, device):
        self.spans = spans
        self.device = device
        self.prof = None
        self.window = None
        self.result = None
        self.started = None

    def _activities(self) -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def prime(self) -> None:
        """One short session in set-up: the profiler's first start
        (CUPTI's initialisation) takes seconds, which would otherwise fall
        inside the window."""
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.__enter__()
        self.window = torch.profiler.record_function(WINDOW)
        self.window.__enter__()
        self.spans.profiling = True
        self.started = time.perf_counter()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.spans.profiling = False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.result = read_trace(events)
        for recs in self.spans.calls.values():
            for rec in recs:
                dev = self.result["by_label"].get(rec["label"])
                if dev is not None:
                    rec["device_s"] = dev


def _short(name: str) -> str:
    """A device operation's name up to its template or argument list."""
    name = re.sub(r"^void ", "", name)
    return re.split(r"[<(]", name, 1)[0].strip() or name


def _union(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(starts, items, t, lookback=256):
    """The latest-starting item (start, end, label) with start <= t <= end,
    among ``items`` sorted by start."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - lookback, -1), -1):
        s, e, label = items[j]
        if e >= t:
            return label
    return None


def read_trace(events: list) -> dict:
    """From a chrome trace of :class:`Profile`'s window: the window's
    length, the device's busy time in it (the union of its operations'
    intervals), the device seconds launched inside each ``pb:`` range, the
    ten device operations that took most time and the ten host activities
    under which the device idled longest."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no traced window")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    launches = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))

    # pb: ranges by thread, and each launch's host time by thread
    ranges = defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" and \
                e.get("name", "").startswith("pb:") and e["name"] != WINDOW:
            ranges[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    launched = defaultdict(list)          # tid -> [(ts, device seconds)]
    intervals, by_name = [], defaultdict(float)
    for e in device:
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        lo, hi = max(s, w0), min(s + d, w1)
        if hi > lo:
            intervals.append((lo, hi))
            by_name[_short(e.get("name", "?"))] += (hi - lo) / 1e6
        corr = e.get("args", {}).get("correlation")
        if corr in launches:
            ts, tid = launches[corr]
            launched[tid].append((ts, d / 1e6))
    by_label: dict[str, float] = {}
    for tid, rs in ranges.items():
        ls = sorted(launched.get(tid, []))
        times = [t for t, _ in ls]
        prefix = [0.0]
        for _, d in ls:
            prefix.append(prefix[-1] + d)
        for s, e, label in rs:
            i, j = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
            if j > i:
                by_label[label] = prefix[j] - prefix[i]

    busy = _union(intervals)
    busy_s = sum(e - s for s, e in busy) / 1e6
    # idle gaps inside the window, named by what the host was doing
    marks = [w0] + [x for iv in busy for x in iv] + [w1]
    host = sorted((s, e, re.sub(r":\d+$", "", label))
                  for rs in ranges.values() for s, e, label in rs)
    host_starts = [h[0] for h in host]
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e.get("name", "?")) for e in xs
                 if e.get("cat") in ("cpu_op",) + LAUNCH_CATS)
    op_starts = [o[0] for o in ops]
    gaps = defaultdict(float)
    for a, b in zip(marks[0::2], marks[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = _innermost(host_starts, host, mid) or \
            _innermost(op_starts, ops, mid) or "host outside any op"
        gaps[label] += (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_s,
            "by_label": by_label,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in idle]}}
