"""Training: closed-loop steps of the port's train step.

Set-up draws the weights from the seed on the card, builds the step of
``repro_torch.launch.steps.make_train_step`` with the workload's AdamW
settings, and drives that same object through its first ``checked`` steps
(three), which warm every shape the window uses; the readings the output
check compares are taken from them.  The window then goes on with the same
step, parameters and optimizer state, back to back, each step on a batch
of its own drawn from the seed (rows all differ), with at most one step
in flight.

End-to-end metrics:

* ``train_tok_s``: the tokens of the window's steps over the time from the
  first step's start to a sync after the last;
* ``setup_s``: process start to the first window step.

The output check, once the window has closed, the peak memory is read and
the program's state is freed: the fp32 reference (``reference/lm.py``,
``reference/adamw.py``) follows the same three steps from the same
weights and batches, keeping the parameters in bf16 as the configuration
does.  Read per leaf, over the larger of the reference's norm of that
leaf and of the median leaf: the first step's gradient as AdamW received
it (the program's from its first moment after one step, ``mu / (1 -
b1)``, undone of the clip by the step's ``grad_norm``), by the gap of the
two norms and by the norm of the two tensors' difference (the program's
copied to the host in set-up); and the parameters' change after three
steps, by the gap of norms.  Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the change.  Each step's loss is read too.  :func:`compare` says which
are compared.
"""

from __future__ import annotations

import statistics
import time

import torch

from harness import model as port
from harness import weights
from harness.trace import Profile, Spans, patched
from harness.work import flash_work, peaks, ssd_work
from reference import adamw as ref_adamw
from reference import lm as ref

def batch(seed: int, step: int, B: int, S: int, vocab: int, device,
          half: bool = False) -> dict:
    """Step ``step``'s rows: token ids uniform over the vocabulary from a
    generator of the seed and the step; labels are the next ids.  ``half``
    (a fault planted in the reference, ``calibrate.py``) leaves the second
    half of the labels out."""
    gen = weights.generator(seed, device, salt=1 + step)
    ids = torch.randint(0, vocab, (B, S + 1), generator=gen, device=device,
                        dtype=torch.int32)
    labels = ids[:, 1:].clone()
    if half:
        labels[:, S // 2:] = -1
    return {"tokens": ids[:, :-1].contiguous(), "labels": labels}


def _clip_scale(norm: float, clip_norm: float) -> float:
    return min(1.0, clip_norm / max(norm, 1e-9))


def reference_readings(spec, sizes: dict, t: dict, seed: int, B: int,
                       S: int, device, fp8: bool = False,
                       half: bool = False, against=None,
                       keep: bool = False) -> dict:
    """The reference's losses, first gradient's leaf norms and ``t
    ["checked"]`` steps' change leaf norms, from the seed's weights and
    batches.  ``against`` (first gradients, leaf by leaf, anywhere) adds
    the norm of each leaf's difference from them as ``diff``; ``keep``
    adds the first gradient itself, on the host, as ``grads``."""
    stored = weights.draw(spec, seed, device)
    leaves = [p for _, p in weights.leaves(stored)]
    opt = {"mu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
           "nu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves]}
    losses, grad_norms, out = [], None, {}
    with ref.exact_fp32():
        for step in range(t["checked"]):
            b = batch(seed, step, B, S, sizes["vocab"], device, half=half)
            live = [p.float().requires_grad_() for p in leaves]
            tree = _rebuild(stored, live)
            loss = ref.loss(tree, sizes, b["tokens"], b["labels"], fp8=fp8)
            grads = torch.autograd.grad(loss, live)
            del tree, live
            losses.append(float(loss.detach()))
            if grad_norms is None:
                grad_norms = [float(g.norm()) for g in grads]
                if against is not None:
                    out["diff"] = [float((g - a.to(g.device)).norm())
                                   for g, a in zip(grads, against)]
                if keep:
                    out["grads"] = [g.detach().cpu() for g in grads]
            ref_adamw.step(opt, leaves, list(grads), step + 1, t["lr"],
                           t["b1"], t["b2"], t["eps"], t["weight_decay"],
                           t["clip_norm"])
            del grads
    del opt
    init = weights.draw(spec, seed, device)
    change = [float((p.float() - q.float()).norm())
              for p, (_, q) in zip(leaves, weights.leaves(init))]
    return {**out, "losses": losses, "grad": grad_norms, "change": change,
            "names": [n for n, _ in weights.leaves(init)]}


def _rebuild(like, leaves):
    it = iter(leaves)

    def build(tree):
        return {k: build(tree[k]) for k in sorted(tree)} \
            if isinstance(tree, dict) else next(it)

    return build(like)


def leaf_gaps(prog: list[float], want: list[float]) -> list[float]:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(want)
    return [abs(p - w) / max(w, med, 1e-30) for p, w in zip(prog, want)]


def leaf_diffs(diff: list[float], want: list[float]) -> list[float]:
    """Each leaf's norm of the difference of the two gradients over the
    larger of the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(want)
    return [d / max(w, med, 1e-30) for d, w in zip(diff, want)]


def compare(prog: dict, want: dict, diff: list[float]) -> tuple[dict, dict]:
    """(the numbers compared, the readings shown beside them); ``diff``
    holds each leaf's norm of the first gradients' difference.

    Compared: the first gradient's difference at the median leaf (the gap
    of norms is of second order in round-off that does not change a
    norm's expectation, so float8 can pass it, ``PERF.md``), its gap of
    norms at the median leaf (its widest leaf swings from seed to seed
    with the round-off of one small per-head vector), and the three
    steps' change at the widest leaf among those the reference's gradient
    moves.  Shown: the widest leaf of both gradient numbers, and each
    step's loss (the widest relative gap), which the float8 control moves
    by only twice the program's own widest."""
    grad = leaf_gaps(prog["grad"], want["grad"])
    rel = leaf_diffs(diff, want["grad"])
    med = statistics.median(want["grad"])
    moves = [g >= 1e-3 * med for g in want["grad"]]
    return ({"grad_diff": statistics.median(rel),
             "grad_gap": statistics.median(grad),
             "change_gap": max(g for g, m in zip(
                 leaf_gaps(prog["change"], want["change"]), moves) if m)},
            {"grad_diff_widest_leaf": max(rel),
             "grad_gap_widest_leaf": max(grad),
             "loss_gap": max(abs(p - w) / abs(w) for p, w in
                             zip(prog["losses"], want["losses"]))})


def _layer_spans(spans: Spans):
    from repro_torch.launch import steps as port_steps
    from repro_torch.models import layers, ssm

    def flash(a, kw, out):
        f, b = flash_work(a[0], a[1], a[2], out, kw.get("causal", True))
        return {"flops": f, "bytes": b}

    def scan(a, kw, out):
        f, b = ssd_work(a[0], a[1], a[2], a[3], out[0], out[1])
        return {"flops": f, "bytes": b}

    return [patched(layers, "flash_attention",
                    spans.wrap("flash_attention", layers.flash_attention,
                               work=flash)),
            patched(ssm, "ssd_scan",
                    spans.wrap("ssd_scan", ssm.ssd_scan, work=scan)),
            patched(port_steps, "apply_updates",
                    spans.wrap("apply_updates", port_steps.apply_updates,
                               events=True))]


def run(run) -> dict:
    from repro_torch.launch import steps as port_steps
    from repro_torch.optim import AdamWConfig, init_state

    dev = run.device
    model, cfg = port.build(run)
    sizes = port.sizes(run)
    spec = model.spec()
    t = run.cell["train"]
    B, S = t["batch"], t["seq"]
    params = weights.draw(spec, run.seed, dev)
    adamw = AdamWConfig(lr=t["lr"], b1=t["b1"], b2=t["b2"], eps=t["eps"],
                        weight_decay=t["weight_decay"],
                        clip_norm=t["clip_norm"])
    step_fn = port_steps.make_train_step(model, adamw)
    opt = init_state(params)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def feed(step):
        return batch(run.seed, step, B, S, cfg.vocab, dev)

    # set-up: the checked steps, through the window's own call and feed
    prog = {"losses": []}
    for step in range(t["checked"]):
        params, opt, m = step_fn(params, opt, feed(step))
        prog["losses"].append(float(m["loss"]))
        if step == 0:
            # the gradient AdamW received, from its first moment: mu holds
            # (1 - b1) x the gradient clipped by min(1, clip / grad_norm)
            clip = _clip_scale(float(m["grad_norm"]), t["clip_norm"]) \
                if "grad_norm" in m else 1.0
            first = [(mu.float() / ((1.0 - t["b1"]) * clip)).cpu()
                     for _, mu in weights.leaves(opt["mu"])]
            prog["grad"] = [float(g.norm()) for g in first]
    init = weights.draw(spec, run.seed, dev)
    prog["change"] = [float((p.float() - q.float()).norm()) for (_, p), (_, q)
                      in zip(weights.leaves(params), weights.leaves(init))]
    del init

    spans = Spans(dev)
    patches = _layer_spans(spans) if run.trace else []
    if run.trace:
        step_fn = spans.wrap("train_step", step_fn, events=True,
                             extra=lambda: {"tokens": B * S})
    profile = Profile(spans, dev) if run.trace else None
    if profile is not None:
        profile.prime()
    prof_at = run.seconds * run.cell.get("profile_at", 0.4)
    prof_steps = run.cell.get("profile_steps", 2)
    for p in patches:
        p.__enter__()
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_open = time.perf_counter()
        done, prev, traced = 0, None, 0
        while True:
            if profile is not None and profile.result is None:
                if profile.prof is None and \
                        time.perf_counter() - t_open >= prof_at:
                    profile.start()
                elif profile.prof is not None:
                    traced += 1
            params, opt, m = step_fn(params, opt, feed(t["checked"] + done))
            done += 1
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                if prev is not None:
                    prev.synchronize()
                prev = ev
            if profile is not None and profile.prof is not None and \
                    traced >= prof_steps:
                profile.stop()
            if time.perf_counter() - t_open >= run.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_close = time.perf_counter()
        if profile is not None and profile.prof is not None:
            profile.stop()
    finally:
        for p in reversed(patches):
            p.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    spans.resolve()
    metrics = {"train_tok_s": done * B * S / (t_close - t_open),
               "setup_s": t_open - run.process_start}
    record = {"path": "train", "calls": dict(spans.calls),
              "n_params": weights.count(spec), "window": (t_open, t_close),
              "peak": peaks(torch.cuda.get_device_name(dev))
              if dev.type == "cuda" else None,
              "trace": None if profile is None else profile.result}

    del params, opt, m, step_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_readings(spec, sizes, t, run.seed, B, S, dev,
                              against=first)
    del first
    numbers, shown = compare(prog, want, want["diff"])
    limits = run.cell["check"]
    return {"shown": shown, "attempted": done, "failed": 0, "metrics": metrics,
            "memory_peak_bytes": int(peak), "record": record,
            "trace": record["trace"],
            "readings": {"program": prog, "reference": want},
            "checks": {k: {"value": v, "limit": limits[k]}
                       for k, v in numbers.items()}}
