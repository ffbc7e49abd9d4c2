"""Fault tolerance: checkpoint/restart, straggler mitigation, failure
simulation hooks for the training loop.

Design for 1000+ nodes (DESIGN.md §5):

* **Checkpoint/restart** — CheckpointManager (async, atomic) + the
  deterministic data pipeline (step-indexed) make restart a pure function
  of the last checkpoint step; no iterator state, no host-count coupling.
* **Straggler mitigation** — per-step wall-time watermarking with a robust
  (median + MAD) threshold; hosts flagged as stragglers get their DP shard
  reassigned by rebuilding the device->shard map (on TPU fleets slow hosts
  are usually sick hosts).  The detector is runnable anywhere; the
  reassignment is exercised in simulation in tests.
* **Failure detection** — heartbeat registry with a pluggable clock; a
  missed deadline triggers the elastic re-plan (runtime/elastic.py), which
  is a Scission re-query over cached benchmark data.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class StepRecord:
    step: int
    host: int
    wall_s: float


class StragglerDetector:
    """Flags hosts whose recent step times exceed median + k·MAD."""

    def __init__(self, window: int = 16, k: float = 6.0):
        self.window = window
        self.k = k
        self._times: dict[int, list[float]] = {}

    def record(self, host: int, wall_s: float) -> None:
        ts = self._times.setdefault(host, [])
        ts.append(wall_s)
        del ts[:-self.window]

    def stragglers(self) -> list[int]:
        if len(self._times) < 2:
            return []
        medians = {h: statistics.median(ts)
                   for h, ts in self._times.items() if ts}
        overall = statistics.median(medians.values())
        mad = statistics.median(
            abs(m - overall) for m in medians.values()) or 1e-6
        return [h for h, m in medians.items()
                if m > overall + self.k * mad]


class HeartbeatRegistry:
    """Deadline-based liveness; `now` injectable for tests."""

    def __init__(self, timeout_s: float = 60.0,
                 now: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.now = now
        self._last: dict[str, float] = {}

    def beat(self, member: str) -> None:
        self._last[member] = self.now()

    def dead(self) -> list[str]:
        t = self.now()
        return [m for m, last in self._last.items()
                if t - last > self.timeout_s]

    def members(self) -> list[str]:
        return sorted(self._last)


@dataclass
class ShardAssignment:
    """host -> list of DP shard indices; rebuilt when membership changes."""

    n_shards: int
    hosts: list[int]
    assignment: dict[int, list[int]] = field(default_factory=dict)

    def __post_init__(self):
        self.rebalance(self.hosts)

    def rebalance(self, hosts: list[int]) -> dict[int, list[int]]:
        hosts = sorted(hosts)
        assert hosts, "no hosts left"
        self.assignment = {h: [] for h in hosts}
        for s in range(self.n_shards):
            self.assignment[hosts[s % len(hosts)]].append(s)
        self.hosts = hosts
        return self.assignment

    def drop_host(self, host: int) -> dict[int, list[int]]:
        return self.rebalance([h for h in self.hosts if h != host])


class TrainSupervisor:
    """Glues detector + heartbeat + checkpointing around a step function.

    Used by launch/train.py; failure injection in tests drives the same
    code paths a real fleet controller would take.
    """

    def __init__(self, ckpt_manager, detector: StragglerDetector | None = None,
                 heartbeat: HeartbeatRegistry | None = None,
                 ckpt_every: int = 100):
        self.ckpt = ckpt_manager
        self.detector = detector or StragglerDetector()
        self.heartbeat = heartbeat or HeartbeatRegistry()
        self.ckpt_every = ckpt_every
        self.events: list[str] = []

    def resume_or_init(self, init_fn: Callable[[], tuple], like=None):
        restored = self.ckpt.restore_latest(like) if like is not None else None
        if restored is None:
            state = init_fn()
            return state, 0
        tree, step, _ = restored
        self.events.append(f"resumed@{step}")
        return tree, step

    def after_step(self, step: int, state, wall_s: float, host: int = 0):
        self.detector.record(host, wall_s)
        self.heartbeat.beat(f"host{host}")
        if self.ckpt_every and step > 0 and step % self.ckpt_every == 0:
            self.ckpt.save(step, state)
            self.events.append(f"ckpt@{step}")
        s = self.detector.stragglers()
        if s:
            self.events.append(f"stragglers@{step}:{s}")
        return s
