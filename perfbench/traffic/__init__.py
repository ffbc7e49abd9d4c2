"""Traffic: one general generator over the parameters in a workload's
file, and the statistics the metrics take.

:func:`poisson_trace` and :func:`percentile` are frozen copies of the
port's own (``src/repro_torch/serving/requests.py`` and
``src/repro_torch/serving/metrics.py``, commit 69e19e2), so that a later
change to the program cannot move the yardstick.

Every seed gets the same work in another order: the arrival gaps and the
request sizes are drawn once from the mix's ``shape_seed``, and the run's
seed shuffles them within the warm-up and within the window and draws the
token ids.  So runs on different seeds differ in the order of the work,
not in its amount.
"""

from __future__ import annotations

import math

import numpy as np


def poisson_trace(rate_rps: float, horizon_s: float,
                  seed: int = 0) -> list[float]:
    """Arrival times of a homogeneous Poisson process at ``rate_rps`` over
    ``horizon_s``: i.i.d. exponential gaps, deterministic given ``seed``.
    Frozen copy of ``repro_torch.serving.requests.poisson_trace`` (commit
    69e19e2), returning the times alone."""
    if rate_rps <= 0.0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if horizon_s <= 0.0:
        raise ValueError(f"horizon_s must be > 0, got {horizon_s}")
    rng = np.random.default_rng(seed)
    times: list[float] = []
    t = 0.0
    chunk = max(16, int(rate_rps * horizon_s * 1.25) + 16)
    while t < horizon_s:
        for gap in rng.exponential(1.0 / rate_rps, chunk):
            t += gap
            if t >= horizon_s:
                break
            times.append(t)
    return times


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile: the smallest observed value >= ``p``% of
    the sample (0.0 for an empty sample).  Frozen copy of
    ``repro_torch.serving.metrics.percentile`` (commit 69e19e2)."""
    if not 0 < p <= 100:
        raise ValueError(f"percentile must be in (0, 100], got {p}")
    xs = sorted(xs)
    if not xs:
        return 0.0
    rank = max(1, math.ceil(p * len(xs) / 100.0 - 1e-9))
    return xs[min(rank, len(xs)) - 1]


def _sizes(rng, dist: dict, n: int) -> np.ndarray:
    """``n`` whole sizes from ``{"dist": "log_uniform", "lo", "hi"}``
    (inclusive)."""
    if dist["dist"] == "log_uniform":
        lo, hi = math.log(dist["lo"]), math.log(dist["hi"] + 1)
        return np.minimum(np.exp(rng.uniform(lo, hi, n)).astype(np.int64),
                          dist["hi"])
    raise ValueError(f"unknown size distribution {dist['dist']!r}")


def _seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def open_loop(mix: dict, seed: int, spans: list[float], vocab: int) -> list:
    """Requests of an open-loop mix over consecutive spans of time (the
    warm-up, then the window): a list of ``(due_s, prompt ids, new
    tokens)`` sorted by due time.  Each span keeps the arrivals that the
    mix's ``shape_seed`` puts in it, their gaps and sizes shuffled by
    ``seed`` within the span, so every seed brings the same work into the
    window.

    ``mix``: ``arrivals`` ("poisson"), ``rate_rps``, ``prompt_len`` and
    ``new_tokens`` (size distributions), ``shape_seed``."""
    if mix["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    times = np.asarray(poisson_trace(mix["rate_rps"], float(sum(spans)),
                                     mix["shape_seed"]))
    shape = np.random.default_rng(mix["shape_seed"] + 1)
    prompts = _sizes(shape, mix["prompt_len"], len(times))
    news = _sizes(shape, mix["new_tokens"], len(times))
    rng = np.random.default_rng(_seed(seed))
    out, start = [], 0.0
    for span in spans:
        part = np.flatnonzero((times >= start) & (times < start + span))
        gaps = np.diff(np.concatenate([[start], times[part]]))
        due = start + np.cumsum(gaps[rng.permutation(len(part))])
        order = part[rng.permutation(len(part))]
        out += [(float(t), rng.integers(0, vocab, int(prompts[i]))
                 .astype(np.int32), int(news[i]))
                for t, i in zip(due, order)]
        start += span
    return out
