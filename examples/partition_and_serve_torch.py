"""End-to-end driver of the port: partition a transformer LM with Scission
and serve batched requests through the pipeline executor and the serving
engine, on the card.

    PYTHONPATH=src python examples/partition_and_serve_torch.py [--device cpu]

The port of ``examples/partition_and_serve.py``, with its four steps on its
reduced gemma2-family LM (4 layers, d_model 128, local layers with a
sliding window of 16 beside global ones, softcaps), in bf16:

1. Builds the LM and adapts it to a Scission LayerGraph (one node per layer
   group).
2. Benchmarks it on the emulated device/edge/cloud testbed under 4G and
   picks the lowest-latency partition (paper Steps 1-6); the blocks run
   ``flash_attention``.
3. Executes the partitioned forward pipeline on a prompt batch and checks
   it against the unpartitioned model.
4. Serves a batch of generation requests with the continuous-batching
   engine (greedy decode, ragged lengths): prefill through
   ``flash_attention``, decode through ``decode_attention``, whose window
   masks the local layers once a sequence is longer than 16.
"""

import argparse
import sys

sys.path.insert(0, "src")
sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.common_torch import scission_for  # noqa: E402
from repro_torch.core import Query  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.graph_adapter import lm_to_graph  # noqa: E402
from repro_torch.runtime.pipeline import PipelineExecutor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402


def reduced_lm(device):
    cfg = get_config("gemma2-9b").replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, window=16, remat=False, q_chunk=64,
        loss_seq_chunk=None, query_pre_attn_scalar=32.0)
    model = build_model(cfg, device=device)
    params = model.init(seed=0)
    return cfg, model, params


def main(argv=None):
    """Runs the four steps; returns the model, its weights, the engine and
    its finished requests, for a caller that checks them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg, model, params = reduced_lm(args.device)
    B, S = 2, 32

    print("== 1. adapt LM -> Scission layer graph ==")
    graph = lm_to_graph(model, params, batch=B, seq_len=S)
    print(f"   {graph.name}: {graph.n_layers} nodes, "
          f"{len(graph.partition_points())} partition points")

    print("== 2. benchmark + query (Steps 1-6) ==")
    s = scission_for("4g", device=args.device)
    s.benchmark(graph)
    res = s.query(graph.name, Query(top_n=3), input_bytes=B * S * 4)
    for cfgp in res.configs:
        print("   ", cfgp.describe())
    best = res.configs[0]

    print("== 3. execute the partitioned pipeline ==")
    execu = PipelineExecutor(graph, best, s.network, source="device",
                             device=args.device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           dtype=torch.int32).to(model.device)
    got, timings = execu.run(tokens, collect_timing=True)
    for t in timings:
        print(f"   stage on {t.resource}: compute={t.compute_s * 1e3:.1f}ms "
              f"(host) comm_in={t.comm_in_s * 1e3:.1f}ms "
              f"({t.bytes_in / 1e3:.0f}KB)")
    # parity with the unpartitioned model
    hidden, _ = model.forward(params, tokens)
    want = L.unembed(params["embed"], hidden[:, -1:],
                     softcap=cfg.final_softcap)
    # the same kernels in another grouping of the same layers: bf16 values
    # within rounding, decisions (argmax) exact
    torch.testing.assert_close(got.float(), want.float(), atol=1e-1,
                               rtol=0)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    print("   partitioned == unpartitioned (argmax exact, values ±bf16) ✓")

    print("== 4. serve batched requests (continuous batching) ==")
    eng = ServingEngine(model, params, width=4, max_len=64)
    rng = np.random.default_rng(0)
    for rid in range(6):
        plen = int(rng.integers(4, 12))
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab, plen),
                           max_new_tokens=8))
    done = eng.run()
    for r in sorted(done, key=lambda r: r.rid):
        lat = (r.finished_at - r.submitted_at) * 1e3
        print(f"   req{r.rid}: prompt={len(r.prompt)} -> "
              f"{len(r.tokens)} tokens in {lat:.0f}ms: {r.tokens}")
    assert len(done) == 6
    print("   served 6/6 ✓")
    return model, params, eng, done


if __name__ == "__main__":
    main()
