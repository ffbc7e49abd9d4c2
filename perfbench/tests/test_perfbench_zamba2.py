"""The two cells of the published Zamba2 and of long prompts on the CPU at
tiny sizes, and the readers of their new metrics on synthetic records."""

import pytest
import torch
from conftest import TINY
from helpers import run_tiny

from harness import files, work

ZAMBA, LONG = "zamba2-7b.chat", "granite-8b.long-prompt"


@pytest.fixture(autouse=True)
def one_thread():
    """Each run on one CPU thread: at these sizes more threads only
    contend with other work on the host, and a tick that takes ten times
    as long finishes no request in the short window."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# tiny sizes: the published block's structure kept (two blocks in turn at
# irregular positions, concat input, LoRA, 2 groups, a chunk that ragged
# prompts do not fill); granite's bucketed admission at width 4
TINY.setdefault(ZAMBA, (
    {"n_layers": 9, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
     "head_dim": 32, "d_ff": 128, "vocab": 256, "ssm_state": 16,
     "ssm_head_dim": 16, "ssm_chunk": 8, "hybrid_layer_ids": [1, 3, 6, 8],
     "shared_adapter_rank": 4, "query_pre_attn_scalar": 16.0},
    {"engine": {"width": 4, "max_len": 128, "prompt_buckets": None},
     "traffic": {"rate_rps": 4.0, "warmup_s": 0.5,
                 "prompt_len": {"dist": "log_uniform", "lo": 8, "hi": 40},
                 "new_tokens": {"dist": "log_uniform", "lo": 4, "hi": 12}},
     "profile_s": 0.5, "check": {"sample_tokens": 40}}))
TINY.setdefault(LONG, (
    TINY["granite-8b.chat"][0],
    {"engine": {"width": 4, "max_len": 64, "prompt_buckets": "auto"},
     "traffic": {"rate_rps": 6.0, "warmup_s": 0.5,
                 "prompt_len": {"dist": "log_uniform", "lo": 20, "hi": 48},
                 "new_tokens": {"dist": "log_uniform", "lo": 2, "hi": 6}},
     "profile_s": 0.5, "check": {"sample_tokens": 40}}))


@pytest.mark.parametrize("cell,metrics", [
    (ZAMBA, {"ttft_p50_ms", "tpot_p95_ms", "out_tok_s", "setup_s"}),
    (LONG, {"ttft_p50_ms", "out_tok_s", "setup_s"})])
def test_a_sound_run_reports_its_metrics_and_passes(cell, metrics,
                                                    monkeypatch):
    r = run_tiny(cell, monkeypatch=monkeypatch)
    assert set(r["metrics"]) == metrics
    assert r["attempted"] > 0 and r["correct"] is True


def test_the_zamba2_runner_checks_against_its_own_reference():
    serve = files.path_module("serve_zamba2")
    assert serve._serve.ref.__name__ == "reference.zamba2"
    assert files.path_module("serve").ref.__name__ == "reference.lm"


def test_the_zamba2_check_catches_an_altered_token(monkeypatch):
    from repro_torch.serving import engine

    make = engine.make_decode_step

    def altered(model):
        step = make(model)

        def run(*args):
            nxt, logits, cache = step(*args)
            return (nxt + 1) % model.cfg.vocab, logits, cache

        return run

    monkeypatch.setattr(engine, "make_decode_step", altered)
    r = run_tiny(ZAMBA, monkeypatch=monkeypatch)
    gap = r["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"] and r["correct"] is False


def test_a_traced_zamba2_run_leaves_device_metrics_out_off_the_card(
        monkeypatch):
    r = run_tiny(ZAMBA, trace=1, monkeypatch=monkeypatch)
    assert set(r["metrics"]) == {"queue_wait_p95_ms"}


def _span(name, attrs, device_s=None, t=1.5):
    return {"name": name, "id": 1, "parent": None, "thread": 0,
            "t0_ns": int(t * 1e9), "t1_ns": int((t + 0.1) * 1e9),
            "attrs": attrs, "device_s": device_s}


RECORD = {"window": (1.0, 3.0), "peak": (989e12, 3.35e12), "calls": {}}


def test_the_new_readers_on_synthetic_spans(monkeypatch):
    from repro_torch import tracing
    recs = [_span("zamba2.shared_block", {"tokens": 1000}, 0.012),
            _span("zamba2.shared_block", {"tokens": 500}, 0.004),
            _span("zamba2.shared_block", {"tokens": 34}),   # decode: none
            _span("zamba2.shared_block", {"tokens": 100}, 1.0, t=5.0),
            _span("engine.admit", {"rids": [1, 2], "prompt_tokens": 402,
                                   "padded_tokens": 4 * 512}),
            _span("engine.admit", {"rids": [3], "prompt_tokens": 301,
                                   "padded_tokens": 4 * 512}),
            _span("engine.admit", {"rid": 4, "prompt_tokens": 50})]
    monkeypatch.setattr(tracing, "spans", lambda: recs)
    # per 1000 prompt tokens: 12 ms and 8 ms, the one outside the window
    # and the one without events left out
    assert files.metric_module("shared_block_ms").read(RECORD) == \
        pytest.approx(10.0)
    assert files.metric_module("prefill_pad_share").read(RECORD) == \
        pytest.approx(100 * (1 - 700 / 4096))
    # a program whose spans carry no such attribute reads nothing
    monkeypatch.setattr(tracing, "spans", lambda: recs[-1:])
    assert files.metric_module("prefill_pad_share").read(RECORD) is None
    assert files.metric_module("shared_block_ms").read(RECORD) is None
    assert files.metric_module("ssd_scan_roofline.serve").read(RECORD) \
        is None


def test_ssd_work_reads_a_groups_maps_once():
    B, S, H, P, N, G = 1, 256, 8, 16, 4, 2
    x = torch.empty(B, S, H, P, dtype=torch.bfloat16)
    log_a = torch.empty(B, S, H)
    xbc = torch.empty(B, S, 2 * G * N, dtype=torch.bfloat16)
    b = xbc[..., :G * N].unflatten(2, (G, N))
    c = xbc[..., G * N:].unflatten(2, (G, N))
    y, fin = torch.empty_like(x), torch.empty(B, H, N, P)
    flops, nbytes = work.ssd_work(x, log_a, b, c, y, fin)
    assert flops == 4 * B * S * H * N * P
    assert nbytes == (2 * x.numel() * 2 + log_a.numel() * 4
                      + 2 * B * S * G * N * 2 + fin.numel() * 4)


def test_applied_params_count_each_shared_application():
    import types
    serve = files.path_module("serve_zamba2")
    run = types.SimpleNamespace(config=files.config("zamba2-7b"),
                                overrides={}, device=torch.device("cpu"))
    # 7.357e9 stored; each of the 2 blocks (334M) applied 6.5 times on
    # average over the 13 applications: 7.357e9 + 11 x 334M
    assert serve.applied_params(run) == pytest.approx(11.03e9, rel=0.01)


def test_mfu_applied_reads_the_applied_count_in_n_s_place():
    calls = {"prefill": [{"t0": 1.5, "t1": 1.6, "event_s": 0.1,
                          "profiled": False, "useful": 1000}],
             "decode": [{"t0": 2.0, "t1": 2.01, "event_s": 0.01,
                         "profiled": False, "rows": 30}]}
    rec = {**RECORD, "calls": calls, "n_params": 1e9}
    for step in ("prefill", "decode"):
        plain = files.metric_module(f"mfu.{step}").read(rec)
        applied = files.metric_module(f"mfu_applied.{step}")
        # a record without the count (any other runner) reads nothing
        assert applied.read(rec) is None
        assert applied.read({**rec, "n_applied": 1.5e9}) == \
            pytest.approx(1.5 * plain)
