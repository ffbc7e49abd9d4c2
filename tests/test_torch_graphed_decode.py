"""The decode step replayed as CUDA graphs (``launch/steps.py``
``_DecodeGraphs``, ``_device.capture_chain``), rehearsed on the CPU.

On the CPU the step runs eagerly and counts no capture or replay.  The
chain itself is walked with ``torch.cuda``'s graph, stream and generator
calls stubbed: the body then runs for real on CPU tensors while "captured",
which shows where the cuts fall in each family (one per ``decode_attention``
call of the eager step, with its arguments), that a replay makes each cut
call through the name ``layers.decode_attention`` holds at that moment,
with ``out=`` its buffer, between the graphs in their order, and when the
step captures anew.  The graphs' numbers are held on the card
(``tests/test_torch_gpu.py``).  JAX-free.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from repro_torch import _device, tracing
from repro_torch.launch import steps
from repro_torch.models import build_model, get_config
from repro_torch.models import layers as L

SMALL = dict(d_model=64, n_heads=4, head_dim=16, d_ff=128, vocab=128,
             ssm_state=8, ssm_head_dim=8, ssm_chunk=4, remat=False,
             loss_seq_chunk=None)
ARCHS = {"granite-8b": dict(n_layers=3, n_kv_heads=2),
         "gemma2-9b": dict(n_layers=4, n_kv_heads=2, window=8,
                           query_pre_attn_scalar=16.0),
         "zamba2-2.7b": dict(n_layers=12, n_kv_heads=4),
         "qwen2-moe-a2.7b": dict(n_layers=2, n_kv_heads=4, moe_experts=8,
                                 moe_top_k=2, moe_shared_dff=64,
                                 moe_group_size=64),
         "xlstm-125m": dict(n_layers=4, n_kv_heads=4, d_ff=0)}
B, MAX_LEN = 3, 24


def _model(arch):
    model = build_model(get_config(arch).replace(**{**SMALL, **ARCHS[arch]}),
                        device="cpu")
    return model, model.init(seed=2, dtype=torch.float32)


def _inputs(model, seed=0):
    rng = np.random.default_rng(seed)
    token = torch.from_numpy(rng.integers(0, 128, (B, 1), dtype=np.int32))
    lengths = torch.tensor([5, 0, 17], dtype=torch.int32)
    cache = model.init_cache(B, MAX_LEN)
    for leaf in L.tree_leaves(cache):
        leaf.copy_(torch.from_numpy(rng.standard_normal(leaf.shape))
                   .to(leaf.dtype))
    return cache, token, lengths


class _Graph:
    """``torch.cuda.CUDAGraph`` as a log of its calls."""

    log: list = []

    def __init__(self):
        self.n = sum(1 for e in self.log if e[0] == "new")
        self.log.append(("new", self.n))

    def capture_begin(self, pool=None):
        self.log.append(("begin", self.n, pool))

    def capture_end(self):
        self.log.append(("end", self.n))

    def replay(self):
        self.log.append(("replay", self.n))

    def reset(self):
        self.log.append(("reset", self.n))


class _Stream:
    def wait_stream(self, other):
        pass


class _Generator:
    def clone_state(self):
        return "state"

    def graphsafe_set_state(self, state):
        raise AssertionError("no capture failed")


@pytest.fixture
def stub_cuda(monkeypatch):
    """The CUDA calls of ``capture_chain`` stubbed; yields the graphs'
    log."""
    _Graph.log = []
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(cuda, "default_generators", [_Generator()])
    monkeypatch.setattr(cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(cuda, "device", lambda i: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(_device, "_capture_stream", lambda i: _Stream())
    yield _Graph.log


def _eager_calls(model, params, cache, token, lengths):
    """The ``decode_attention`` calls of one eager step: (args, kwargs)."""
    calls, real = [], L.decode_attention

    def record(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    L.decode_attention = record
    try:
        model.decode_step(params, token, cache, lengths)
    finally:
        L.decode_attention = real
    return calls


def _step_body(model):
    def body(params, cache, token, cache_len):
        logits, cache = model.decode_step(params, token, cache, cache_len)
        return logits.argmax(-1), logits, cache
    return body


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_chain_cuts_at_each_decode_attention_call(arch, stub_cuda):
    """One graph more than the eager step's ``decode_attention`` calls,
    begun and ended in turn in one pool; each cut holds its call's
    arguments and kwargs and a buffer of the query's shape and dtype, which
    the rest of the step reads as the attention's output."""
    model, params = _model(arch)
    cache, token, lengths = _inputs(model)
    want = _eager_calls(model, params, {k: L.tree_map(torch.clone, v)
                                        for k, v in cache.items()},
                        token, lengths)
    assert (len(want) > 0) == (arch != "xlstm-125m")
    chain = _device.capture_chain(_step_body(model),
                                  (params, cache, token, lengths),
                                  torch.device("cpu"), L, "decode_attention")
    assert L.decode_attention.__module__ == \
        "repro_torch.kernels.decode_attention"
    n = len(want) + 1
    assert len(chain.graphs) == n and len(chain.cuts) == len(want)
    assert [e for e in stub_cuda if e[0] != "new"] == [
        e for i in range(n) for e in (("begin", i, "pool"), ("end", i))]
    for (args, kwargs, buf), (w_args, w_kwargs) in zip(chain.cuts, want):
        assert kwargs == w_kwargs
        assert [tuple(a.shape) for a in args] == \
            [tuple(a.shape) for a in w_args]
        assert buf.shape == args[0].shape and buf.dtype == args[0].dtype
        assert torch.equal(args[3], w_args[3])          # the lengths
    if arch == "gemma2-9b":
        assert {kw["window"] for _, kw, _ in chain.cuts} == {None, 8}


def test_a_capture_that_fails_raises_and_unbinds_the_cut(stub_cuda):
    """A body that fails after a cut raises, with the graph it was in
    ended and ``layers.decode_attention`` bound as before; nothing falls
    back to an eager call."""
    model, params = _model("granite-8b")
    cache, token, lengths = _inputs(model)
    real = L.decode_attention

    def body(*args):
        L.decode_attention(torch.zeros(B, 4, 16), None, None, None)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        _device.capture_chain(body, (params, cache, token, lengths),
                              torch.device("cpu"), L, "decode_attention")
    assert L.decode_attention is real
    assert [e for e in stub_cuda if e[0] != "new"] == [
        ("begin", 0, "pool"), ("end", 0), ("begin", 1, "pool"), ("end", 1)]


def test_replay_calls_the_name_bound_now_between_the_graphs(stub_cuda):
    """A replay runs graph 0, then per cut the function
    ``layers.decode_attention`` names at that moment with ``out=`` the
    cut's buffer (which it fills), then the next graph."""
    model, params = _model("granite-8b")
    cache, token, lengths = _inputs(model)
    chain = _device.capture_chain(_step_body(model),
                                  (params, cache, token, lengths),
                                  torch.device("cpu"), L, "decode_attention")
    del stub_cuda[:]
    real = L.decode_attention

    def wrapper(*a, out=None, **kw):
        stub_cuda.append(("call", out))
        got = real(*a, out=out, **kw)
        assert got is out
        return got

    L.decode_attention = wrapper
    try:
        for _, _, buf in chain.cuts:
            buf.fill_(float("nan"))
        out = chain.replay()
    finally:
        L.decode_attention = real
    assert out is chain.out
    n = ARCHS["granite-8b"]["n_layers"]
    assert len(chain.cuts) == n
    want = [("replay", 0)]
    for i, (_, _, buf) in enumerate(chain.cuts):
        want += [("call", buf), ("replay", i + 1)]
    assert len(stub_cuda) == len(want)
    assert all(a[0] == b[0] and a[1] is b[1] if a[0] == "call" else a == b
               for a, b in zip(stub_cuda, want))
    for args, kwargs, buf in chain.cuts:
        # past the first cut the "captured" body read unset buffers
        torch.testing.assert_close(buf, real(*args, **kwargs), rtol=0,
                                   atol=0, equal_nan=True)
    chain.release()
    assert stub_cuda[-n - 1:] == [("reset", i) for i in range(n + 1)]
    assert chain.graphs == [] and chain.cuts == [] and chain.out is None


def _graph_counts() -> tuple[int, int]:
    counts = tracing.counters()
    return counts["decode_graph_captures"], counts["decode_graph_replays"]


def test_step_captures_once_per_cache_and_replays_after(stub_cuda):
    """``_DecodeGraphs``: the first call on a cache is the eager step (its
    outputs returned) and a capture; later calls on it replay, with the
    token and lengths copied into the static buffers and the outputs
    copied out; another cache captures anew and frees the previous chain;
    the cache handed back is the caller's."""
    model, params = _model("granite-8b")
    cache, token, lengths = _inputs(model)
    graphs = steps._DecodeGraphs(_step_body(model))
    c0, r0 = _graph_counts()
    (tok, logits, out_cache), replayed = graphs(params, cache, token,
                                                lengths)
    assert not replayed and _graph_counts() == (c0 + 1, r0)
    assert out_cache is cache
    for i in range(3):
        new_tok, new_len = token + i + 1, lengths + i + 1
        (tok, logits, out_cache), replayed = graphs(params, cache, new_tok,
                                                    new_len)
        assert replayed and out_cache is cache
        assert torch.equal(graphs.token, new_tok)
        assert torch.equal(graphs.lengths, new_len)
        assert tok is not graphs.chain.out[0]
        assert logits is not graphs.chain.out[1]
        # past the first cut the "captured" body read unset buffers
        torch.testing.assert_close(logits, graphs.chain.out[1], rtol=0,
                                   atol=0, equal_nan=True)
    assert _graph_counts() == (c0 + 1, r0 + 3)
    # a scalar length is broadcast into the static buffer
    graphs(params, cache, token, 7)
    assert graphs.lengths.tolist() == [7] * B
    first = graphs.chain
    other, _, _ = _inputs(model, seed=1)
    _, replayed = graphs(params, other, token, lengths)
    assert not replayed and graphs.chain is not first
    assert _graph_counts()[0] == c0 + 2 and first.graphs == []
    assert any(e[0] == "reset" for e in stub_cuda)
    _, replayed = graphs(params, other, token, lengths)
    assert replayed


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b"])
def test_step_on_the_cpu_runs_eagerly(arch):
    """On CPU tensors the step takes the eager path: no capture, no
    replay, and its spans say ``graphed=False``."""
    model, params = _model(arch)
    cache, token, lengths = _inputs(model)
    decode = steps.make_decode_step(model)
    before = _graph_counts()
    tracing.stop()
    tracing.clear()
    tracing.start()
    try:
        for _ in range(3):
            token, logits, cache = decode(params, cache, token, lengths)
            lengths = lengths + 1
    finally:
        tracing.stop()
    assert _graph_counts() == before
    recs = [r for r in tracing.spans() if r["name"] == "step.decode"]
    tracing.clear()
    assert [r["attrs"] for r in recs] == [{"graphed": False}] * 3


def test_graphs_take_plain_cuda_tensors_of_a_decoder_only_model():
    """The graphs take plain CUDA tensors of a decoder-only model under no
    mesh; the CPU, ``meta``, a mesh and the encoder-decoder stay eager."""
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    dec, _ = _model("granite-8b")
    whisper = build_model(get_config("whisper-medium"), device="meta")
    assert steps._graphed(dec, None, on_card)
    assert not steps._graphed(dec, None, torch.zeros(2, 1))
    assert not steps._graphed(dec, None, torch.empty(2, 1, device="meta"))
    assert not steps._graphed(dec, object(), on_card)
    assert not steps._graphed(whisper, None, on_card)
