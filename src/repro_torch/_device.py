"""Device selection and timing shared by the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``:
measurements and kernels belong on the card, and a run that finds no card
fails here instead of silently timing the CPU.  Tests pass ``device="cpu"``.

On the card a block is timed the way the reference times a compiled
program (``jax.jit`` of the block, one dispatch per sample): one call is
captured in a CUDA graph (:func:`capture`) and each sample is one replay of
it (:func:`replay_seconds`), so a sample is the block's device time and not
the host's launch work.
"""

from __future__ import annotations

import functools
import warnings

import torch

# ~0.1 ms at the H100's clocks: longer than the host takes to enqueue the
# start event, one graph launch and the end event
HOLD_CYCLES = 200_000
# the longest hold, ~0.4 s: a graph of tens of thousands of nodes (an
# sLSTM block's 2048 serial steps) takes the host tens of ms to launch
MAX_HOLD_CYCLES = 4096 * HOLD_CYCLES


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for all queued work on ``device`` (a no-op off the card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def _capture_stream(index: int) -> torch.cuda.Stream:
    # capture needs a stream other than the legacy default one
    return torch.cuda.Stream(index)


def capture(fn, args: tuple, device: torch.device):
    """One call of ``fn(*args)`` on ``device``, captured in a CUDA graph and
    not run: returns ``(graph, output)``, the output being filled by each
    ``graph.replay()``.  A call that cannot be captured (a host sync, a
    copy from pageable host memory) raises; nothing falls back to an eager
    call.  Unlike ``torch.cuda.graph`` this empties no cache before the
    capture, which would cost a ``cudaFree`` and a new ``cudaMalloc`` per
    block timed."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _capture_stream(index)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(index):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                out = fn(*args)
            finally:
                with warnings.catch_warnings():
                    # a block of views alone launches nothing: its graph
                    # is empty, and its replays take no device time
                    warnings.filterwarnings(
                        "ignore", message="The CUDA Graph is empty")
                    graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
    return graph, out


def replay_seconds(fn, args: tuple, runs: int,
                   device: torch.device) -> list[float]:
    """``runs`` samples of ``fn(*args)``'s device time on ``device``, in
    seconds: one call is captured in a CUDA graph, replayed once (the first
    replay uploads the graph), and each sample is one replay between two
    CUDA events.  The device is held busy (``torch.cuda._sleep``) before
    each sample so that the host has enqueued the start event, the replay
    and the end event before the start event fires; where it has fired
    already the hold is doubled and the sample taken again.  The graph and
    its memory pool are released before returning."""
    graph, out = capture(fn, args, device)
    del out                  # the replays write it; nothing reads it
    samples: list[float] = []
    try:
        with torch.cuda.device(device):
            graph.replay()
            torch.cuda.synchronize()
            cycles = HOLD_CYCLES
            while len(samples) < runs:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(cycles)
                start.record()
                graph.replay()
                end.record()
                early = start.query()
                end.synchronize()
                if not early:
                    samples.append(start.elapsed_time(end) / 1e3)
                elif cycles >= MAX_HOLD_CYCLES:
                    raise RuntimeError(
                        "replay_seconds: the host still enqueues the replay "
                        f"after a hold of {cycles} cycles")
                else:
                    cycles *= 2
    finally:
        graph.reset()
    return samples
