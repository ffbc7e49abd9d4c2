"""Device selection and timing shared by the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``:
measurements and kernels belong on the card, and a run that finds no card
fails here instead of silently timing the CPU.  Tests pass ``device="cpu"``.

On the card a block is timed the way the reference times a compiled
program (``jax.jit`` of the block, one dispatch per sample): one call is
captured in a CUDA graph (:func:`capture`) and each sample is one replay of
it (:func:`replay_seconds`), so a sample is the block's device time and not
the host's launch work.  :func:`capture_chain` captures a call as graphs
cut at each call of one function, which stays an eager launch between
their replays (the serving decode step, ``launch/steps.py``).
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


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _end_capture(graph, generator, before) -> None:
    """``graph.capture_end()``.  capture_begin puts the default generator's
    state in capture mode and capture_end takes it out, after ending the
    stream's capture: where that raises (a capture the body invalidated),
    the state stays in capture mode and every later draw on the card
    raises.  ``before``, a copy of the state from before the capture (a
    fresh state object, not in capture mode; graphsafe_get_state would
    share the live one), is put back then."""
    with warnings.catch_warnings():
        # a block of views alone launches nothing: its graph is empty, and
        # its replays take no device time
        warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
        try:
            graph.capture_end()
        except BaseException:
            generator.graphsafe_set_state(before)
            raise


def capture(fn, args: tuple, device: torch.device):
    """One call of ``fn(*args)`` on ``device``, captured in a CUDA graph and
    not run: returns ``(graph, output)``, the output being filled by each
    ``graph.replay()``.  A call that cannot be captured (a host sync, a
    copy from pageable host memory) raises; nothing falls back to an eager
    call.  Unlike ``torch.cuda.graph`` this empties no cache before the
    capture, which would cost a ``cudaFree`` and a new ``cudaMalloc`` per
    block timed."""
    index = _index(device)
    stream = _capture_stream(index)
    graph = torch.cuda.CUDAGraph()
    generator = torch.cuda.default_generators[index]
    before = generator.clone_state()
    with torch.cuda.device(index):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                out = fn(*args)
            finally:
                _end_capture(graph, generator, before)
        torch.cuda.current_stream().wait_stream(stream)
    return graph, out


class GraphChain:
    """A call captured by :func:`capture_chain`: CUDA graphs in one memory
    pool, with the calls it was cut at made eagerly between them."""

    def __init__(self, graphs, cuts, out, module, name):
        self.graphs, self.cuts, self.out = graphs, cuts, out
        self.module, self.name = module, name

    def replay(self):
        """Replay the first graph, then for each cut call the function
        ``module.<name>`` names now, with the recorded arguments and
        ``out=`` its buffer, and replay the next graph.  Returns the
        captured call's output, which the next replay overwrites."""
        self.graphs[0].replay()
        for (args, kwargs, buf), graph in zip(self.cuts, self.graphs[1:]):
            getattr(self.module, self.name)(*args, out=buf, **kwargs)
            graph.replay()
        return self.out

    def release(self) -> None:
        """Free the graphs; the pool's memory goes back to the allocator
        once the chain is dropped."""
        for graph in self.graphs:
            graph.reset()
        self.graphs, self.cuts, self.out = [], [], None


def capture_chain(fn, args: tuple, device: torch.device, module,
                  name: str) -> GraphChain:
    """One call of ``fn(*args)`` on ``device`` captured, not run, as a
    chain of CUDA graphs that share one private memory pool, cut at each
    call of ``module.<name>``.  While the capture runs, that name is bound
    to a cut: it records its arguments and a buffer shaped as its first
    argument (the function must write its output into ``out=``, of its
    first argument's shape and dtype), ends the current graph, begins the
    next and hands the buffer on as the output.  The tensors each cut
    records stay alive in the pool, so no later graph takes their memory;
    the graphs must be replayed in their order, which
    :meth:`GraphChain.replay` does.  A call that cannot be captured raises,
    as in :func:`capture`."""
    index = _index(device)
    stream = _capture_stream(index)
    pool = torch.cuda.graph_pool_handle()
    graphs = [torch.cuda.CUDAGraph()]
    cuts: list = []
    capturing = False
    generator = torch.cuda.default_generators[index]
    before = generator.clone_state()

    def begin():
        nonlocal capturing
        graphs[-1].capture_begin(pool=pool)
        capturing = True

    def cut(first, *rest, **kwargs):
        nonlocal capturing
        buf = torch.empty_like(first)
        cuts.append(((first, *rest), kwargs, buf))
        capturing = False
        _end_capture(graphs[-1], generator, before)
        graphs.append(torch.cuda.CUDAGraph())
        begin()
        return buf

    real = getattr(module, name)
    with torch.cuda.device(index):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            setattr(module, name, cut)
            try:
                begin()
                out = fn(*args)
            finally:
                setattr(module, name, real)
                if capturing:
                    _end_capture(graphs[-1], generator, before)
        torch.cuda.current_stream().wait_stream(stream)
    return GraphChain(graphs, cuts, out, module, name)


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
