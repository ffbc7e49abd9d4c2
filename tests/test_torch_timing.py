"""How the port times blocks and autotuner candidates, on the CPU.

On the card ``TimingProvider`` and ``KernelAutotuner`` time replays of a
CUDA graph (``repro_torch._device.replay_seconds``; the GPU tests hold the
replays against eager calls).  On the CPU and on ``meta`` both stay eager:
these tests forbid the graph path and run them there.  The autotuner
keeps the default block sizes unless a candidate beats them by more than
``substrate.TOLERANCE``.
"""

import pytest
import torch

import repro_torch.core.bench as bench_mod
import repro_torch.kernels.substrate as substrate_mod
from repro_torch.core import (LayerNode, Resource, TensorSpec,
                              TimingProvider, fuse_blocks, linear_graph)
from repro_torch.core.resources import CLOUD_VM
from repro_torch.kernels import KernelAutotuner


@pytest.fixture
def no_graphs(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph was asked for off the card")
    monkeypatch.setattr(bench_mod, "replay_seconds", refuse)
    monkeypatch.setattr(substrate_mod, "replay_seconds", refuse)


def _block():
    g = linear_graph("mlp", TensorSpec((2, 8), torch.float32),
                     [LayerNode("a", "dense", apply=lambda x: torch.tanh(x)),
                      LayerNode("b", "dense", apply=lambda x: x * 2.0)])
    return fuse_blocks(g)[-1]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_timing_provider_is_eager_off_the_card(no_graphs, device):
    res = Resource("edge", "edge", CLOUD_VM, speed_factor=3.0)
    mean, std, flops, nbytes = TimingProvider(device=device).measure(
        _block(), res, runs=4, batch=2)
    assert mean > 0.0 and std >= 0.0 and (flops, nbytes) == (0.0, 0.0)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_autotuner_times_candidates_eagerly_off_the_card(no_graphs, device):
    calls = []

    def fn(x):
        calls.append(x.device.type)
        return x + 1

    tuner = KernelAutotuner(runs=3, device=device)
    assert tuner._time_candidate(fn, (torch.ones(4, device=device),)) >= 0.0
    assert calls == [device] * 4                     # warm-up + 3 runs


def _tune(times):
    """The winner of a two-candidate sweep whose times ``measure`` gives by
    block size; the default is ``{"chunk": 128}``."""
    tuner = KernelAutotuner(
        candidates={"ssd_scan": [{"chunk": 64}, {"chunk": 128}]},
        measure=lambda fn, args: times[fn.chunk], device="cpu")

    def factory(params):
        def fn(x):
            return x
        fn.chunk = params["chunk"]
        return fn

    return tuner.tune("ssd_scan", factory, (torch.ones(2),)).params


@pytest.mark.parametrize("faster,winner", [
    (0.995, 128),    # within the tolerance of the default: it stays
    (1.0, 128),      # a tie keeps the default
    (0.98, 64),      # faster by more than the tolerance: the candidate wins
])
def test_autotuner_keeps_the_default_within_its_tolerance(faster, winner):
    assert substrate_mod.TOLERANCE == 0.01
    assert _tune({64: faster, 128: 1.0}) == {"chunk": winner}
