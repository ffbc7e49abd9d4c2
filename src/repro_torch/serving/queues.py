"""Per-stage bounded queues, prompt buckets, and the KV cache slot pool.

The queueing layer of the request plane: :class:`StageQueue` is the
bounded FIFO every router stage and the engine admission path share (depth
telemetry included, so queue-depth histograms come for free), and
:class:`KVCachePool` is the serving engine's slot-per-sequence cache pool
(moved here from the old monolithic ``serving/engine.py``).

``PROMPT_BUCKETS`` / :func:`bucket_for` implement the padded-prompt-bucket
scheme: admissions that happen in the same engine tick are batched into
**one** prefill call whose sequence length is the smallest bucket covering
the longest prompt in the group, so the number of distinct prefill
compilations is bounded by the bucket count instead of growing with every
distinct prompt length seen.
"""

from __future__ import annotations

from collections import Counter, deque
from typing import Any

import numpy as np

# small fixed set: at most len(PROMPT_BUCKETS) prefill compiles per engine,
# regardless of how many distinct prompt lengths arrive
PROMPT_BUCKETS: tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024)


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= ``n`` (the exact length when none covers it —
    an escape hatch, not the steady state; callers clip buckets to their
    maximum sequence length up front)."""
    if n <= 0:
        raise ValueError(f"bucket size must be positive, got {n}")
    for b in sorted(buckets):
        if b >= n:
            return b
    return n


class StageQueue:
    """Bounded FIFO with depth telemetry.

    ``push`` returns False (and counts a rejection) when the queue is at
    its limit — the caller sheds or back-pressures; nothing is silently
    dropped.  ``depth_histogram`` counts how often each depth was observed
    at push time, the raw material for the queue-depth histograms on the
    serving metrics.
    """

    def __init__(self, limit: int | None = None):
        if limit is not None and limit < 1:
            raise ValueError(f"queue limit must be >= 1, got {limit}")
        self.limit = limit
        self._q: deque[Any] = deque()
        self.offered = 0
        self.rejected = 0
        self.peak_depth = 0
        self.depth_histogram: Counter[int] = Counter()

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def push(self, item: Any) -> bool:
        self.offered += 1
        self.depth_histogram[len(self._q)] += 1
        if self.limit is not None and len(self._q) >= self.limit:
            self.rejected += 1
            return False
        self._q.append(item)
        self.peak_depth = max(self.peak_depth, len(self._q))
        return True

    def pop(self) -> Any:
        return self._q.popleft()

    def popleft(self) -> Any:
        return self._q.popleft()


class KVCachePool:
    """Fixed-width slot pool over the stacked cache pytree.

    Slot i owns batch row i of every cache leaf.  Freeing a slot just
    recycles the row (lengths are tracked per slot) — sequence-granularity
    paging, the memory-management layer a vLLM-style block table would
    refine further.
    """

    def __init__(self, model, width: int, max_len: int):
        self.width = width
        self.max_len = max_len
        self.cache = model.init_cache(batch=width, max_len=max_len)
        self.lengths = np.zeros(width, np.int32)
        self.free = deque(range(width))
        self.slot_req: dict[int, int] = {}

    def acquire(self, rid: int) -> int | None:
        if not self.free:
            return None
        slot = self.free.popleft()
        self.lengths[slot] = 0
        self.slot_req[slot] = rid
        return slot

    def release(self, slot: int) -> None:
        self.slot_req.pop(slot, None)
        self.lengths[slot] = 0
        self.free.append(slot)
