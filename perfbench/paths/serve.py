"""Serving: open-loop traffic through the port's ``ServingEngine``.

Set-up draws the weights from the seed on the card, builds the engine
(``width``, ``max_len`` and admission from the workload's file: bucketed,
or exact with ``"prompt_buckets": null``), warms the decode step and the
prefills the traffic will use, then serves the mix's first ``warmup_s``
seconds of arrivals so that the window opens on a loaded engine.  The window drives the engine through ``submit`` and
``run(max_steps=1)``: each request is submitted once it is due, with its
``submitted_at`` set to its due time, and each call admits what fits and
runs one decode step.

End-to-end metrics, over the window (``BENCHMARK.json`` says which a cell
reports; all four latencies are shown beside the result):

* ``ttft_p50_ms``, ``ttft_p95_ms``: first token on the host minus the due
  time, the median and the 95th percentile over every request due in the
  window; one still waiting at the close counts with its wait so far;
* ``tpot_p50_ms``, ``tpot_p95_ms``: (finish - first token) / (tokens - 1),
  over the requests completed in the window;
* ``out_tok_s``: generated tokens that reached the host in the window,
  over the window;
* ``setup_s``: process start to the window's opening.

The output check: once the window has closed and the peak memory is read,
the engine is freed and a sample of the finished requests, drawn from the
seed with the longest among them, is run through the fp32 reference over
each prompt and its served tokens.  The number compared is the widest gap
by which a served token's logit lies below the reference's best at its
position (every token is greedy).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

import traffic
from harness import model as port
from harness import weights
from harness.trace import Profile, Spans, patched
from harness.work import decode_work, flash_work, peaks
from reference import lm as ref


def _warm(eng, requests, Request) -> None:
    """Every shape the traffic uses, once.  Bucketed admission: the
    engine's own warm-up over one request of each prompt bucket (the
    decode step included).  Exact admission prefills each request alone
    at its own length, with no shape to build: one prefill at the longest
    prompt and one decode step over the pool, whose free slots the
    admissions overwrite whole (the engine's warm-up would allocate a
    second cache as wide as the pool)."""
    if eng.prompt_buckets is None:
        n = max(len(p) for _, p, _ in requests)
        single = eng.model.init_cache(batch=1, max_len=eng.max_len)
        eng._prefill(eng.params, single,
                     {"tokens": eng._tensor(np.zeros((1, n)))})
        del single
        _, _, eng.pool.cache = eng._decode(
            eng.params, eng.pool.cache, eng._tensor(eng._next_tok),
            eng._tensor(eng.pool.lengths))
        return
    from repro_torch.serving.queues import bucket_for
    sizes = sorted({bucket_for(max(len(p) - 1, 1), eng.prompt_buckets)
                    for _, p, _ in requests})
    eng.queue = [Request(rid=-1, prompt=np.zeros(b + 1, np.int32),
                         max_new_tokens=1) for b in sizes]
    eng.warmup()
    eng.queue = []


def _layer_spans(eng, spans: Spans, state: dict):
    """Wrappers of the engine's steps and of the attention kernels the
    model layers call; returns the patches to enter."""
    from repro_torch.models import layers

    # the prompt tokens each prefill serves: all of an exact admission's
    # prompt; in a bucket, each admitted prompt but its last token (which
    # the first decode step takes)
    if eng.prompt_buckets is None:
        admit_exact = eng._admit_exact

        def admit_one(req, slot):
            state["useful"] = len(req.prompt)
            return admit_exact(req, slot)

        eng._admit_exact = admit_one
    else:
        admit_bucketed = eng._admit_bucketed

        def admit_batch(batch):
            state["useful"] = sum(len(r.prompt) - 1 for r, _ in batch)
            return admit_bucketed(batch)

        eng._admit_bucketed = admit_batch
    eng._prefill = spans.wrap(
        "prefill", eng._prefill, events=True,
        extra=lambda: {"useful": state.pop("useful", 0)})

    def decode_extra():
        state["lengths"] = eng.pool.lengths + 1
        return {"rows": len(eng.active)}

    eng._decode = spans.wrap("decode", eng._decode, events=True,
                             extra=decode_extra)

    def flash(a, kw, out):
        f, b = flash_work(a[0], a[1], a[2], out, kw.get("causal", True))
        return {"flops": f, "bytes": b}

    def decode(a, kw, out):
        f, b = decode_work(a[0], a[1], state["lengths"], out)
        return {"flops": f, "bytes": b}

    return [patched(layers, "flash_attention",
                    spans.wrap("flash_attention", layers.flash_attention,
                               work=flash)),
            patched(layers, "decode_attention",
                    spans.wrap("decode_attention", layers.decode_attention,
                               work=decode))]


def _sample(done, seed: int, tokens: int) -> list:
    """Finished requests drawn from the seed, the one with the most served
    tokens first, until ``tokens`` served tokens are in the sample."""
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), len(r.prompt)))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(int(seed) % (1 << 63) + 17)
    out, n = [longest], len(longest.tokens)
    for i in rng.permutation(len(rest)):
        if n >= tokens:
            break
        out.append(rest[int(i)])
        n += len(rest[int(i)].tokens)
    return out


def logit_gaps(params, cfg: dict, reqs, device, fp8: bool = False):
    """Per sampled request, the fp32 reference's best logit minus the
    logit of the served token at each served position; with ``fp8`` the
    gap of the token the float8 control puts first instead (read in the
    fp32 logits)."""
    seqs, served = [], []
    for r in reqs:
        ids = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
        seqs.append(torch.as_tensor(ids, device=device))
        served.append(torch.as_tensor(r.tokens, device=device).long())
    exact = ref.logits(params, cfg, seqs)
    ctrl = ref.logits(params, cfg, seqs, fp8=True) if fp8 else None
    gaps = []
    for i, (r, toks) in enumerate(zip(reqs, served)):
        lg = exact[i][len(r.prompt) - 1:]
        pick = toks if ctrl is None else \
            ctrl[i][len(r.prompt) - 1:].argmax(-1)
        gaps.append(lg.max(-1).values
                    - lg.gather(-1, pick[:, None])[:, 0])
    return gaps


def run(run) -> dict:
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.requests import Request

    dev = run.device
    model, cfg = port.build(run)
    sizes = port.sizes(run)
    spec = model.spec()
    params = weights.draw(spec, run.seed, dev)
    n_params = weights.count(spec)
    mix, engine = run.cell["traffic"], run.cell["engine"]
    warm_s = mix["warmup_s"]
    requests = traffic.open_loop(mix, run.seed, [warm_s, run.seconds],
                                 cfg.vocab)
    eng = ServingEngine(model, params, width=engine["width"],
                        max_len=engine["max_len"],
                        prompt_buckets=engine.get("prompt_buckets", "auto"))
    _warm(eng, requests, Request)

    spans, state, patches = Spans(dev), {}, []
    if run.trace:
        patches = _layer_spans(eng, spans, state)
    rows = [0]
    inner = eng._decode

    def counted(*args):
        rows[0] = len(eng.active)
        return inner(*args)

    eng._decode = counted
    profile = Profile(spans, dev) if run.trace else None
    if profile is not None:
        profile.prime()
    prof_at = run.seconds * run.cell.get("profile_at", 0.4)
    prof_len = run.cell.get("profile_s", 3.0)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    submitted, made = [], 0
    for p in patches:
        p.__enter__()
    try:
        t_base = time.perf_counter()
        t_open = t_base + warm_s
        t_close = t_open + run.seconds
        i = 0
        while True:
            now = time.perf_counter()
            if now >= t_close:
                break
            if profile is not None:
                if profile.prof is None and profile.result is None and \
                        now >= t_open + prof_at:
                    profile.start()
                elif profile.prof is not None and \
                        now >= profile.started + prof_len:
                    profile.stop()
            while i < len(requests) and t_base + requests[i][0] <= now:
                due, prompt, new = requests[i]
                r = Request(rid=i, prompt=prompt, max_new_tokens=new,
                            submitted_at=t_base + due)
                eng.submit(r)
                submitted.append(r)
                i += 1
            if eng.queue or eng.active:
                rows[0] = 0
                eng.run(max_steps=1)
                if t_open <= time.perf_counter() <= t_close:
                    made += rows[0]
            else:
                nxt = t_base + requests[i][0] if i < len(requests) \
                    else t_close
                time.sleep(max(0.0, min(nxt, t_close) - now))
        if profile is not None and profile.prof is not None:
            profile.stop()
    finally:
        for p in reversed(patches):
            p.__exit__(None, None, None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        peak = 0
    spans.resolve()

    in_window = [(r, due) for r, (due, _, _) in
                 zip(submitted, requests) if t_open <= t_base + due < t_close]
    # requests due in the window but not yet submitted when it closed
    for due, _, _ in requests[len(submitted):]:
        if t_open <= t_base + due < t_close:
            in_window.append((None, due))
    ttft = [((r.first_token_at if r is not None and r.first_token_at
              is not None and r.first_token_at <= t_close else t_close)
             - (t_base + due)) * 1e3 for r, due in in_window]
    tpot = [(r.finished_at - r.first_token_at) / (len(r.tokens) - 1) * 1e3
            for r in submitted if r.done and r.finished_at <= t_close
            and len(r.tokens) > 1]
    tails = {"ttft_p50_ms": traffic.percentile(ttft, 50),
             "ttft_p95_ms": traffic.percentile(ttft, 95),
             "tpot_p50_ms": traffic.percentile(tpot, 50),
             "tpot_p95_ms": traffic.percentile(tpot, 95)}
    metrics = {**tails, "out_tok_s": made / run.seconds,
               "setup_s": t_open - run.process_start}
    record = {
        "path": "serve", "calls": dict(spans.calls), "n_params": n_params,
        "window": (t_open, t_close),
        "peak": peaks(torch.cuda.get_device_name(dev))
        if dev.type == "cuda" else None,
        # queue waits of the requests due before the profiler started: its
        # overhead slows the engine, and the queue behind it
        "requests": [(t_base + due, None if r is None else r.admitted_at)
                     for r, due in in_window
                     if profile is None or profile.started is None
                     or t_base + due < profile.started],
        "trace": None if profile is None else profile.result}

    counts = {"due": len(in_window),
              "completed": sum(1 for r in submitted if r.done
                               and t_open <= r.finished_at <= t_close),
              "waiting_at_close": len(eng.queue) + sum(
                  1 for r, _ in in_window if r is None),
              "active_at_close": len(eng.active),
              **tails}

    # the output check, after the program's state is freed
    done = [r for r in submitted if r.done]
    sample = _sample(done, run.seed, run.cell["check"]["sample_tokens"])
    # the wrappers around the engine's steps refer back to it: collect the
    # cycle so that the pool's memory is free for the reference
    del eng, counted, inner, patches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gaps = logit_gaps(params, sizes, sample, dev)
    widest = max((float(g.max()) for g in gaps), default=float("inf"))
    return {"attempted": len(in_window), "failed": 0, "metrics": metrics,
            "shown": tails,
            "memory_peak_bytes": int(peak), "record": record,
            "trace": record["trace"], "window_counts": counts,
            "reference_inputs": {"params": params, "sizes": sizes,
                                 "sample": sample},
            "checks": {"max_logit_gap": {
                "value": widest,
                "limit": run.cell["check"]["max_logit_gap"],
                "served_tokens": sum(len(r.tokens) for r in sample),
                "requests": len(sample)}}}
