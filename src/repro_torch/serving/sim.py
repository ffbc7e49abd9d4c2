"""Closed-form pipeline throughput simulation (predicted-rate validation).

:func:`simulate_pipeline_throughput` moved verbatim from the old
monolithic ``serving/engine.py`` — it is the closed-loop, saturation-fed
counterpart of the open-loop trace-driven :class:`~repro_torch.serving.router.
Router`: it answers "what rate *can* this operating point sustain", while
the router answers "what does this operating point do under *this*
arrival process".  ``benchmarks/bench_partitions.py`` gates the cost
model's ``throughput_rps`` predictions against it.
"""

from __future__ import annotations

import math

from ..core.partition import PartitionConfig


def simulate_pipeline_throughput(config: PartitionConfig,
                                 n_requests: int = 128) -> float:
    """Steady-state request rate of a partition under pipelined serving.

    Discrete-event simulation with the classic pipeline recurrence — the
    unit in flight is one *batch* of ``config.batch_size`` requests, and a
    compute stage with ``replicas[k]`` copies round-robins batches over its
    servers: batch ``i`` enters stage ``s`` when the previous stage has
    produced it and server ``i % replicas`` has finished batch
    ``i - replicas``:

        finish[i][s] = max(finish[i][s-1], finish[i-replicas_s][s])
                       + stage_time[s]

    Stages are the input hop (if any), then compute segments interleaved
    with inter-stage comm hops; hops are single-server (the link is the
    server).  The measured request rate (batch rate × batch size) converges
    to the cost model's ``1 / bottleneck_s`` prediction;
    benchmarks/bench_partitions.py uses this to validate predicted vs.
    simulated throughput.

    Raises ``ValueError`` for ``n_requests < 2``, a config with no
    pipeline stages — there is no steady state to measure, and the old
    ``inf`` return silently poisoned predicted-vs-simulated comparisons —
    or a ``replicas`` entry below 1 (a zero-replica stage serves nothing;
    the old code would round-robin over an empty server list).
    """
    if n_requests < 2:
        raise ValueError(
            f"need at least 2 requests to measure a steady-state rate, "
            f"got n_requests={n_requests}")
    if any(r < 1 for r in config.replicas):
        raise ValueError(
            f"every replicas entry must be >= 1, got {config.replicas}")
    batch = max(1, config.batch_size)
    stages: list[tuple[float, int]] = []       # (per-batch time, replicas)
    if config.input_comm_s > 0.0:
        stages.append((config.input_comm_s, 1))
    for k, t in enumerate(config.stage_compute_s):
        stages.append((t, config.replica_count(k)))
        if k < len(config.stage_comm_s):
            stages.append((config.stage_comm_s[k], 1))
    if not stages:
        raise ValueError(
            "config has no pipeline stages (no stage_compute_s/input hop); "
            "evaluate it through CostModel.evaluate before simulating")
    # enough batches that every replica set wraps around several times —
    # fewer and the measured span can be zero (all in-flight batches finish
    # simultaneously on distinct servers, no steady state yet).  The joint
    # pattern of a replicated pipeline repeats with period lcm(replicas) in
    # batch index, so the run must also cover whole joint periods.
    max_reps = max(reps for _, reps in stages)
    period = math.lcm(*(reps for _, reps in stages))
    warm = 2 * max_reps               # fill-up: every set wraps >= twice
    n_batches = max(4 * max_reps, 2 * (warm + period + 1),
                    -(-n_requests // batch))
    finish = [[0.0] * reps for _, reps in stages]
    done: list[float] = []
    for i in range(n_batches):
        prev = 0.0
        for s, (dt, reps) in enumerate(stages):
            srv = i % reps
            finish[s][srv] = max(prev, finish[s][srv]) + dt
            prev = finish[s][srv]
        done.append(prev)
    # measure the steady-state rate over (roughly) the second half, but:
    # start only after every replica set has wrapped at least twice, and
    # measure a whole number of joint periods — finish times within a wrap
    # are bursty, so a window that cuts a period mid-wrap biases the rate
    lo = max(len(done) // 2, warm + 1)
    whole = (len(done) - lo) // period * period
    start = len(done) - whole
    span = done[-1] - done[start - 1]
    if span <= 0.0:
        raise ValueError(
            "steady-state span is zero (every stage time is zero?) — "
            "cannot measure a finite pipeline rate")
    return whole / span * batch
