"""Request lifecycle + open-loop arrival traces.

The request plane distinguishes two request shapes:

* :class:`Request` — the serving engine's unit of work: a concrete prompt
  (token array) flowing through prefill/decode with per-phase timestamps.
* :class:`Arrival` — a trace event: *when* a request arrives and how big
  it is, with no token content.  The router and the throughput benchmarks
  operate on arrivals; :func:`arrivals_to_requests` materializes them into
  engine requests when real tokens are needed.

Traces are **open-loop**: arrival times are drawn up front from a seeded
process and do not depend on service times, so an overloaded system sees
the queue build instead of the load politely waiting — the regime the
paper's "millions of users" story (and any SLO metric) actually lives in.
Two generators are provided:

* :func:`poisson_trace` — homogeneous Poisson (exponential i.i.d. gaps),
  the classic steady-rate workload.
* :func:`bursty_diurnal_trace` — non-homogeneous Poisson via thinning: a
  sinusoidal diurnal envelope between a base and a peak rate, with
  optional periodic burst windows multiplying the instantaneous rate.

Both are deterministic given a seed (numpy ``default_rng``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    """One serving-engine request and its lifecycle timestamps.

    ``submitted_at`` is stamped at construction (client-side submit);
    ``admitted_at`` when the engine moves it from the admission queue into
    a cache slot (queue wait = ``admitted_at - submitted_at``);
    ``first_token_at`` when the first generated token lands (TTFT);
    ``finished_at`` at completion.  ``deadline_s`` is an optional
    per-request SLO, relative to submission — consumers (router admission
    control, goodput metrics) treat a missing deadline as "no SLO".
    """

    rid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 16
    submitted_at: float = field(default_factory=time.perf_counter)
    tokens: list[int] = field(default_factory=list)
    done: bool = False
    first_token_at: float | None = None
    finished_at: float | None = None
    admitted_at: float | None = None
    deadline_s: float | None = None

    @property
    def queue_wait_s(self) -> float | None:
        """Time spent in the admission queue (None until admitted)."""
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def latency_s(self) -> float | None:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


@dataclass(frozen=True)
class Arrival:
    """One open-loop trace event: a request arriving ``t`` seconds after
    the trace start."""

    t: float
    rid: int
    prompt_len: int = 32
    max_new_tokens: int = 16


def _lens(rng: np.random.Generator, n: int, prompt_len) -> np.ndarray:
    if isinstance(prompt_len, tuple):
        lo, hi = prompt_len
        return rng.integers(lo, hi + 1, n)
    return np.full(n, int(prompt_len))


def poisson_trace(rate_rps: float, horizon_s: float, seed: int = 0,
                  prompt_len: int | tuple[int, int] = 32,
                  max_new_tokens: int = 16) -> list[Arrival]:
    """Homogeneous Poisson arrivals at ``rate_rps`` over ``horizon_s``.

    Gaps are i.i.d. exponential with mean ``1/rate_rps``; ``prompt_len``
    may be a fixed int or an inclusive ``(lo, hi)`` range sampled per
    request.  Deterministic given ``seed``.
    """
    if rate_rps <= 0.0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if horizon_s <= 0.0:
        raise ValueError(f"horizon_s must be > 0, got {horizon_s}")
    rng = np.random.default_rng(seed)
    # draw in chunks: E[n] = rate * horizon, oversample to cover the tail
    times: list[float] = []
    t = 0.0
    chunk = max(16, int(rate_rps * horizon_s * 1.25) + 16)
    while t < horizon_s:
        for gap in rng.exponential(1.0 / rate_rps, chunk):
            t += gap
            if t >= horizon_s:
                break
            times.append(t)
    lens = _lens(rng, len(times), prompt_len)
    return [Arrival(t=times[i], rid=i, prompt_len=int(lens[i]),
                    max_new_tokens=max_new_tokens)
            for i in range(len(times))]


def bursty_diurnal_trace(base_rps: float, peak_rps: float, horizon_s: float,
                         period_s: float, seed: int = 0,
                         burst_factor: float = 1.0,
                         burst_every_s: float | None = None,
                         burst_len_s: float = 0.0,
                         prompt_len: int | tuple[int, int] = 32,
                         max_new_tokens: int = 16) -> list[Arrival]:
    """Non-homogeneous Poisson: diurnal sinusoid + periodic bursts.

    The instantaneous rate is::

        rate(t) = base + (peak - base) * sin^2(pi * t / period)
        rate(t) *= burst_factor   while (t mod burst_every) < burst_len

    sampled exactly by thinning (candidates at the max rate, accepted with
    probability ``rate(t) / rate_max``), so the empirical rate tracks the
    envelope without discretization bias.  Deterministic given ``seed``.
    """
    if not 0.0 < base_rps <= peak_rps:
        raise ValueError(
            f"need 0 < base_rps <= peak_rps, got {base_rps}/{peak_rps}")
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
    rate_max = peak_rps * burst_factor

    def rate(t: float) -> float:
        r = base_rps + (peak_rps - base_rps) * \
            math.sin(math.pi * t / period_s) ** 2
        if burst_every_s and (t % burst_every_s) < burst_len_s:
            r *= burst_factor
        return r

    rng = np.random.default_rng(seed)
    times: list[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_max)
        if t >= horizon_s:
            break
        if rng.random() < rate(t) / rate_max:
            times.append(t)
    lens = _lens(rng, len(times), prompt_len)
    return [Arrival(t=times[i], rid=i, prompt_len=int(lens[i]),
                    max_new_tokens=max_new_tokens)
            for i in range(len(times))]


def empirical_rate(trace: list[Arrival]) -> float:
    """Observed arrival rate of a trace (requests per second over the span
    from t=0 to the last arrival; 0 for traces with < 2 arrivals)."""
    if len(trace) < 2:
        return 0.0
    span = trace[-1].t
    return (len(trace) - 1) / span if span > 0 else 0.0


def arrivals_to_requests(trace: list[Arrival], vocab: int,
                         seed: int = 0) -> list[Request]:
    """Materialize trace arrivals into engine :class:`Request`\\ s with
    seeded random prompt tokens (``submitted_at`` carries the *virtual*
    arrival offset, matching the trace's clock, not wall time)."""
    rng = np.random.default_rng(seed)
    return [Request(rid=a.rid,
                    prompt=rng.integers(0, vocab, a.prompt_len),
                    max_new_tokens=a.max_new_tokens,
                    submitted_at=a.t)
            for a in trace]
