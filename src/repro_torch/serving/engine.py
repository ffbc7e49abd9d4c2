"""Batched serving engine: continuous-batching decode loop over the
prefill/decode step functions, the port of ``repro/serving/engine.py``.

The engine owns:
* a :class:`KVCachePool` (slot-per-sequence paging at sequence granularity),
* a request queue with admission up to the batch width,
* the prefill/decode steps — same-tick admissions share **one** prefill
  over a padded prompt bucket, instead of one call and a fresh batch-1
  cache per request.

The model runs on its own device (``model.device``, the card unless the
caller asked for the CPU), where the steps launch the hand-written kernels:
``flash_attention`` in every prefill, ``decode_attention`` in every decode
step and, for Mamba-2 models, ``ssd_scan`` in the prefill.  Caches are
written in place: the pool's cache by the decode steps, the scratch cache
of the bucketed path by each admission's prefill (see
:meth:`ServingEngine._admit_bucketed` for why a scratch that holds an
earlier admission's rows gives the same result as the reference's zeros).

Spans (:mod:`..tracing`): ``engine.step`` per loop iteration
(``admitted``, ``rows``), ``engine.admit`` per exact admission (``rid``,
``prompt_tokens``) or per bucket (``rids``, ``prompt_tokens``, and
``padded_tokens``: the width times the bucket the prefill ran), and
``engine.readback`` around each decode step's copy of its tokens to the
host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.partition import PartitionConfig
from ..launch.steps import make_decode_step, make_prefill_step
from ..models.layers import tree_leaves
from .. import tracing
from .metrics import ServingStats, mean, percentile
from .queues import KVCachePool, PROMPT_BUCKETS, bucket_for
from .requests import Request

__all__ = ["RECURRENT_KINDS", "ServingEngine"]

# sub-layer kinds whose cache is a recurrent state rather than per-position
# K/V: a padded prefill would fold the padding into the state irreversibly,
# so bucketed admission auto-disables for models containing any of these
# (attention caches are safe: positions beyond a row's length are never
# visible — the per-row cache_len masks them, and each position is
# overwritten by the real token before cache_len reaches it)
RECURRENT_KINDS = frozenset({"mamba2", "mlstm", "slstm"})


class ServingEngine:
    """Continuous-batching engine, optionally driven by a Scission
    operating point: constructing with ``config=`` (a
    :class:`PartitionConfig`, e.g. a frontier point) sets the admission
    width to the operating point's batch size, so the engine admits exactly
    the concurrency the cost model priced.  An explicit ``width`` always
    wins.

    ``prompt_buckets`` controls admission batching: ``"auto"`` (default)
    batches same-tick admissions into one padded-prompt-bucket prefill for
    attention-cache models and falls back to exact per-request prefill for
    recurrent-state models (see :data:`RECURRENT_KINDS`); an explicit
    tuple forces those buckets; ``None`` forces the exact path.
    """

    def __init__(self, model, params, *, width: int | None = None,
                 max_len: int = 256, eos_id: int | None = None,
                 config: PartitionConfig | None = None,
                 prompt_buckets: tuple[int, ...] | str | None = "auto"):
        if width is None:
            width = config.batch_size if config is not None else 4
        if width < 1:
            raise ValueError(f"admission width must be >= 1, got {width}")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.params = params
        self.config = config
        self.width = width
        self.max_len = max_len
        self.eos_id = eos_id
        self.pool = KVCachePool(model, width, max_len)
        self._prefill = make_prefill_step(model)
        self._decode = make_decode_step(model)
        if prompt_buckets == "auto":
            kinds = set(getattr(self.cfg, "group_kinds", ()) or ())
            prompt_buckets = None if kinds & RECURRENT_KINDS \
                else PROMPT_BUCKETS
        if prompt_buckets is not None:
            # clip to the cache length; always keep one bucket that covers
            # the longest admissible prompt
            prompt_buckets = tuple(sorted(
                {b for b in prompt_buckets if b < max_len} | {max_len}))
        self.prompt_buckets = prompt_buckets
        # scratch cache for the batched bucket prefill and for warm-up,
        # allocated once at first use
        self._scratch = None
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}       # slot -> request
        self._next_tok = np.zeros((width, 1), np.int32)
        self.stats = ServingStats()

    # -- client API -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) > self.max_len - 1:
            raise ValueError(
                f"prompt of request {req.rid} is {len(req.prompt)} tokens; "
                f"the engine's cache holds max_len={self.max_len} (prompt "
                "must leave room for at least one generated token)")
        self.queue.append(req)

    def warmup(self) -> "ServingEngine":
        """Run the decode step and the prefill bucket(s) the queued
        requests will need (the smallest bucket when the queue is empty)
        once, so that the next :meth:`run`'s :class:`ServingStats` measure
        serving, not the kernels' build and first launches.  Idempotent;
        it writes only the scratch cache and fresh caches, so no engine
        state changes."""
        self._decode(self.params, self._scratch_cache(),
                     self._tensor(self._next_tok),
                     self._tensor(self.pool.lengths))
        if self.prompt_buckets is None:
            # the exact path prefills each request at its prompt length;
            # warm each distinct length present in the queue
            lens = sorted({len(r.prompt) for r in self.queue
                           if len(r.prompt) > 1})
            for n in lens:
                single = self.model.init_cache(batch=1, max_len=self.max_len)
                self._prefill(self.params, single,
                              {"tokens": self._tensor(np.zeros((1, n)))})
        else:
            if self.queue:
                buckets = sorted({bucket_for(max(len(r.prompt) - 1, 1),
                                             self.prompt_buckets)
                                  for r in self.queue if len(r.prompt) > 1})
            else:
                buckets = [min(self.prompt_buckets)]
            for b in buckets:
                self._prefill(self.params, self._scratch_cache(),
                              {"tokens": self._tensor(
                                  np.zeros((self.width, b)))})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def run(self, max_steps: int = 10_000) -> list[Request]:
        finished: list[Request] = []
        steps = 0
        t0 = time.perf_counter()
        while (self.queue or self.active) and steps < max_steps:
            with tracing.span("engine.step") as sp:
                admitted = self._admit()
                sp.set(admitted=admitted, rows=len(self.active))
                if self.active:
                    self._decode_step(finished)
            steps += 1
        waits = [r.queue_wait_s for r in finished
                 if r.queue_wait_s is not None]
        self.stats = ServingStats(
            requests=len(finished),
            tokens=sum(len(r.tokens) for r in finished),
            wall_s=time.perf_counter() - t0,
            queue_wait_mean_s=mean(waits),
            queue_wait_p99_s=percentile(waits, 99))
        return finished

    @property
    def measured_throughput_rps(self) -> float:
        """Request throughput observed on the last :meth:`run`."""
        return self.stats.requests_per_s

    # -- internals --------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        """An int32 host array as a tensor on the model's device."""
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _scratch_cache(self):
        if self._scratch is None:
            self._scratch = self.model.init_cache(batch=self.width,
                                                  max_len=self.max_len)
        return self._scratch

    def _admit(self) -> int:
        """Admit what the free slots take; returns how many."""
        batch: list[tuple[Request, int]] = []
        while self.queue and self.pool.free:
            req = self.queue.pop(0)
            slot = self.pool.acquire(req.rid)
            batch.append((req, slot))
        if not batch:
            return 0
        if self.prompt_buckets is None:
            for req, slot in batch:
                self._admit_exact(req, slot)
        else:
            self._admit_bucketed(batch)
        return len(batch)

    def _admit_exact(self, req: Request, slot: int) -> None:
        """Per-request prefill (recurrent-state models): a fresh batch-1
        cache at the prompt's own length, the first token taken from the
        prefill logits."""
        with tracing.span("engine.admit", rid=req.rid,
                          prompt_tokens=len(req.prompt)):
            single = self.model.init_cache(batch=1, max_len=self.max_len)
            logits, single = self._prefill(self.params, single,
                                           {"tokens": self._tensor(
                                               req.prompt)[None, :]})
            tok = int(torch.argmax(logits[0, -1]))
            req.tokens.append(tok)
            req.admitted_at = time.perf_counter()
            req.first_token_at = req.admitted_at
            self._write_slot(single, slot)
        self.pool.lengths[slot] = len(req.prompt)
        self._next_tok[slot, 0] = tok
        self.active[slot] = req

    def _admit_bucketed(self, batch: list[tuple[Request, int]]) -> None:
        """One prefill for every same-tick admission: prompts minus their
        last token are right-padded into the smallest covering bucket
        (fixed batch width), the resulting cache rows are scattered into
        the admitted slots, and the *last* prompt token becomes each slot's
        first decode input — the next decode step then produces the first
        generated token from logits identical to an exact prefill's last
        position (causal attention never sees the right padding, and the
        per-row cache_len masks the padded cache positions until real
        tokens overwrite them).

        The prefill writes rows ``[0, bucket)`` of the scratch cache in
        place, and its attention reads only the rows it wrote; rows past the
        bucket may hold an earlier admission's keys, which are scattered
        into the slots with the rest but lie past each slot's length, so
        they are masked until overwritten, as the padding is."""
        now = time.perf_counter()
        pre = max(len(req.prompt) - 1 for req, _ in batch)
        with tracing.span("engine.admit", rids=[req.rid for req, _ in batch],
                          prompt_tokens=sum(len(req.prompt)
                                            for req, _ in batch)) as sp:
            if pre > 0:
                bucket = bucket_for(pre, self.prompt_buckets)
                sp.set(padded_tokens=self.width * bucket)
                toks = np.zeros((self.width, bucket), np.int32)
                for j, (req, _) in enumerate(batch):
                    toks[j, :len(req.prompt) - 1] = req.prompt[:-1]
                _, cache = self._prefill(self.params, self._scratch_cache(),
                                         {"tokens": self._tensor(toks)})
                self._scatter_rows(cache, rows=list(range(len(batch))),
                                   slots=[slot for _, slot in batch])
        for req, slot in batch:
            req.admitted_at = now
            self.pool.lengths[slot] = len(req.prompt) - 1
            self._next_tok[slot, 0] = int(req.prompt[-1])
            self.active[slot] = req

    def _scatter_rows(self, src_cache, rows: list[int],
                      slots: list[int]) -> None:
        """Copy batch rows ``rows`` of a width-batch cache into pool slots
        ``slots`` (batch lives at axis 1 of every cache leaf, after the
        layer-stack axis)."""
        rows_ix = self._tensor(rows).long()
        slots_ix = self._tensor(slots).long()
        for dst, src in zip(tree_leaves(self.pool.cache),
                            tree_leaves(src_cache)):
            dst[:, slots_ix] = src[:, rows_ix]

    def _write_slot(self, single_cache, slot: int) -> None:
        """Copy a batch-1 cache into pool slot ``slot`` (axis 1 of every
        leaf)."""
        for dst, src in zip(tree_leaves(self.pool.cache),
                            tree_leaves(single_cache)):
            dst[:, slot:slot + 1].copy_(src)

    def _decode_step(self, finished: list[Request]) -> None:
        # ragged continuous batching: per-slot cache lengths drive per-row
        # positions, write offsets and attention masks
        next_tok, _, self.pool.cache = self._decode(
            self.params, self.pool.cache, self._tensor(self._next_tok),
            self._tensor(self.pool.lengths))
        with tracing.span("engine.readback"):
            nxt = next_tok.cpu().numpy()
        now = time.perf_counter()
        for slot, req in list(self.active.items()):
            t = int(nxt[slot, 0])
            req.tokens.append(t)
            if req.first_token_at is None:
                req.first_token_at = now
            self.pool.lengths[slot] += 1
            limit = (len(req.tokens) >= req.max_new_tokens
                     or (self.eos_id is not None and t == self.eos_id)
                     or self.pool.lengths[slot] >= self.max_len - 1)
            if limit:
                req.done = True
                req.finished_at = now
                finished.append(req)
                del self.active[slot]
                self.pool.release(slot)
            else:
                self._next_tok[slot, 0] = t
