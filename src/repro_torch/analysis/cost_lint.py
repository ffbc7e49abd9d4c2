"""Offline soundness checks of a BenchmarkDB + NetworkModel (SCN4xx).

The exact DPs (``core/lattice``) are only exact *under premises*: stage
times and byte counts are finite and non-negative (additive accumulation
and dominance pruning), batch profiles are monotone in batch (the
log-linear interpolation between measured points stays meaningful),
every active resource covers the batches the fleet prices (otherwise
SCN111 clamps silently distort operating points), links behave like the
paper's ``latency + bytes/bandwidth`` model, and the cost model composes
latency additively / bottleneck by max.  None of that is checked at
measurement time — a corrupted DB row or a miswired link silently
produces a confidently-wrong "optimal" partition.

This pass makes the premises checkable offline.  ``QueryEngine`` runs it
once at construction and attaches the findings to every
``QueryResult.diagnostics``; the CLI exposes it as ``scission-lint cost
<db.json | plan.json>``.

Severities: data that breaks an exactness guarantee outright (negative /
NaN times, non-positive bandwidth, broken composition) is an *error*;
data the engine still handles but that degrades fidelity (non-monotone
profiles, coverage gaps, asymmetric or costly self links) is a
*warning* — randomly-wired but well-formed test fleets must stay
error-free.
"""

from __future__ import annotations

import math
from typing import Sequence

from .diagnostics import Diagnostic, ERROR, WARNING

# Reference payload for comparing link costs (asymmetry / self-link
# checks): 1 MiB, a mid-sized activation tensor.
_REF_BYTES = float(1 << 20)

# Relative slack before a profile counts as non-monotone / a link pair as
# asymmetric — real wall-clock profiles carry measurement noise.
_REL_TOL = 0.05


def _finite_nonneg(x: float) -> bool:
    return math.isfinite(x) and x >= 0.0


def lint_cost_db(db, network=None,
                 resources: Sequence[str] | None = None
                 ) -> list[Diagnostic]:
    """SCN401-406: check a :class:`repro_torch.core.bench.BenchmarkDB` (and
    optionally its :class:`repro_torch.core.network.NetworkModel`) against the
    DP premises.  ``resources`` restricts the DB checks to the active
    fleet (a DB may carry stale records for departed resources)."""
    diags: list[Diagnostic] = []
    active = {r: recs for r, recs in db.records.items()
              if resources is None or r in resources}

    # -- SCN401 / SCN402: per-record value sanity + profile monotonicity ----
    batches_by_resource: dict[str, set[int]] = {}
    for rname in sorted(active):
        covered: set[int] = set()
        for rec in active[rname]:
            subject = f"{rname}/block{rec.block}"
            bad: list[str] = []
            if not _finite_nonneg(rec.mean_time_s):
                bad.append(f"mean_time_s={rec.mean_time_s!r}")
            if not (_finite_nonneg(float(rec.output_bytes))):
                bad.append(f"output_bytes={rec.output_bytes!r}")
            for b in sorted(rec.batch_profile):
                t, nbytes = rec.batch_profile[b]
                if not _finite_nonneg(float(t)):
                    bad.append(f"batch_profile[{b}] time={t!r}")
                if not _finite_nonneg(float(nbytes)):
                    bad.append(f"batch_profile[{b}] bytes={nbytes!r}")
            if bad:
                diags.append(Diagnostic(
                    "SCN401", ERROR,
                    f"block {rec.block} on {rname!r} records "
                    f"{'; '.join(bad)} — negative or non-finite stage "
                    f"costs void the lattices' additive accumulation and "
                    f"dominance pruning (a negative-cost stage makes "
                    f"'longer segment is never cheaper' false)",
                    subject=subject,
                    hint="re-benchmark the block; the record is corrupt"))
            bs = sorted(rec.batch_profile)
            covered.update(bs)
            finite = all(_finite_nonneg(float(rec.batch_profile[b][0]))
                         for b in bs)
            if finite:
                for b0, b1 in zip(bs, bs[1:]):
                    t0 = float(rec.batch_profile[b0][0])
                    t1 = float(rec.batch_profile[b1][0])
                    if t1 < t0 * (1.0 - _REL_TOL):
                        diags.append(Diagnostic(
                            "SCN402", WARNING,
                            f"block {rec.block} on {rname!r}: per-batch "
                            f"time drops from {t0:.3g}s @ batch {b0} to "
                            f"{t1:.3g}s @ batch {b1} — a non-monotone "
                            f"profile voids the log-linear interpolation "
                            f"premise, so times at unmeasured batches in "
                            f"({b0}, {b1}) are unreliable",
                            subject=subject,
                            hint="re-measure both batch points (likely a "
                                 "noisy or mislabelled run)"))
        batches_by_resource[rname] = covered

    # -- SCN403: per-resource batch coverage vs the fleet union -------------
    fleet_union: set[int] = set()
    for bs in batches_by_resource.values():
        fleet_union |= bs
    for rname in sorted(batches_by_resource):
        missing = sorted(fleet_union - batches_by_resource[rname])
        if missing:
            have = sorted(batches_by_resource[rname])
            diags.append(Diagnostic(
                "SCN403", WARNING,
                f"resource {rname!r} measured batches {have} but the "
                f"fleet union is {sorted(fleet_union)}: pricing batches "
                f"{missing} on it clamps to the nearest measured point "
                f"(SCN111) and frontier sweeps lose those operating "
                f"points fleet-wide", subject=rname,
                hint=f"benchmark_batches(..., batch_sizes={missing}) for "
                     f"{rname!r}"))

    if network is not None:
        diags.extend(lint_network(network))
    return diags


def lint_network(network) -> list[Diagnostic]:
    """SCN404-406: link-model anomalies."""
    diags: list[Diagnostic] = []
    links = network.links()
    # the default link backs every pair not explicitly connected; probe it
    # through the public fallback path
    default = network.link("__scission_lint__a", "__scission_lint__b")

    def check_link(link, subject: str):
        bad: list[str] = []
        if not math.isfinite(link.latency_s) or link.latency_s < 0.0:
            bad.append(f"latency_s={link.latency_s!r}")
        if math.isnan(link.bandwidth) or link.bandwidth <= 0.0:
            bad.append(f"bandwidth={link.bandwidth!r}")
        if bad:
            diags.append(Diagnostic(
                "SCN404", ERROR,
                f"link {link.name!r} ({subject}) has {', '.join(bad)} — "
                f"hop costs must be finite and non-negative for the DPs' "
                f"additive/minimax composition to hold", subject=subject,
                hint="fix the link definition; comm_time would be "
                     "negative, NaN or infinite"))

    check_link(default, "default")
    for (src, dst) in sorted(links):
        check_link(links[(src, dst)], f"{src}->{dst}")

    # SCN405: both directions explicit but priced differently
    for (src, dst) in sorted(links):
        if src >= dst or (dst, src) not in links:
            continue
        fwd, rev = links[(src, dst)], links[(dst, src)]
        try:
            ta, tb = fwd.comm_time(_REF_BYTES), rev.comm_time(_REF_BYTES)
        except ZeroDivisionError:           # already an SCN404
            continue
        if not (math.isfinite(ta) and math.isfinite(tb)):
            continue
        if abs(ta - tb) > _REL_TOL * max(abs(ta), abs(tb), 1e-12):
            diags.append(Diagnostic(
                "SCN405", WARNING,
                f"explicit link pair {src!r}<->{dst!r} is asymmetric "
                f"({fwd.name!r}: {ta:.3g}s vs {rev.name!r}: {tb:.3g}s per "
                f"{int(_REF_BYTES)} bytes) — plans moving data in the "
                f"unexpected direction are priced differently",
                subject=f"{src}<->{dst}",
                hint="intended? connect(symmetric=True) keeps both "
                     "directions identical"))

    # SCN406: explicit self-link costlier than the default network link
    if math.isfinite(default.comm_time(_REF_BYTES)):
        for (src, dst) in sorted(links):
            if src != dst:
                continue
            t_self = links[(src, dst)].comm_time(_REF_BYTES)
            t_net = default.comm_time(_REF_BYTES)
            if math.isfinite(t_self) and t_self > t_net * (1.0 + _REL_TOL):
                diags.append(Diagnostic(
                    "SCN406", WARNING,
                    f"self-link on {src!r} prices same-box staging at "
                    f"{t_self:.3g}s per {int(_REF_BYTES)} bytes — slower "
                    f"than the default inter-resource link "
                    f"({t_net:.3g}s); a local hop costlier than the "
                    f"network is usually a miswired link table",
                    subject=f"{src}->{src}",
                    hint="check the (src, src) entry; implicit self-links "
                         "are free (LOOPBACK)"))
    return diags


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)


def lint_cost_model(cost) -> list[Diagnostic]:
    """SCN407: verify on the *actual* cost model that latency composes
    additively and the bottleneck by max over every recorded block — the
    two composition laws the Viterbi / minimax / Pareto lattices assume
    when they accumulate prefix sums and max-merge stage periods.

    The check recomputes ``segment_time`` / ``evaluate`` output from the
    raw DB records and compares; a subclass (or corrupted precompute)
    that breaks either law is named with the exact segment and the voided
    guarantee.  Resources with non-finite recorded times are skipped —
    SCN401 already owns those.
    """
    from ..core.lattice.chain import Segment

    diags: list[Diagnostic] = []
    db = cost.db
    batch = cost.batch_size
    B = cost.n_blocks
    names = [r.name for r in cost.resources]

    def block_time(rname: str, j: int) -> float:
        # mirrors BenchmarkDB.time(): the batch-1 scalar short-circuits the
        # profile, larger batches interpolate (without noting clamps)
        rec = db.records[rname][j]
        return float(rec.mean_time_s) if batch == 1 \
            else float(rec.time_at(batch))

    usable: list[str] = []
    for rname in names:
        times = [block_time(rname, j) for j in range(B)]
        if not all(math.isfinite(t) for t in times):
            continue
        usable.append(rname)
        # additivity: segment_time over any prefix == sum of block times
        acc = 0.0
        for j in range(B):
            acc += times[j]
            got = cost.segment_time(rname, 0, j)
            if not _close(got, acc):
                diags.append(Diagnostic(
                    "SCN407", ERROR,
                    f"segment_time({rname!r}, 0, {j}) = {got:.6g}s but the "
                    f"recorded block times sum to {acc:.6g}s — latency is "
                    f"not additive over blocks, voiding the Viterbi "
                    f"lattice's prefix-sum accumulation (its optimum is "
                    f"no longer the true latency optimum)",
                    subject=f"{rname}/blocks0-{j}",
                    hint="the cost model diverges from its DB; rebuild it "
                         "or fix the override"))
                break               # one finding per resource is enough

    # composition of evaluate(): latency additive over stages, bottleneck
    # the max over effective stage periods — sampled over whole-model
    # placements and two-stage splits at representative cuts
    samples: list[list[Segment]] = []
    for rname in usable:
        samples.append([Segment(rname, 0, B - 1)])
    if len(usable) >= 2 and B >= 2:
        r0, r1 = usable[0], usable[1]
        for cut in sorted({0, B // 2, B - 2}):
            if 0 <= cut < B - 1:
                samples.append([Segment(r0, 0, cut),
                                Segment(r1, cut + 1, B - 1)])

    for segs in samples:
        cfg = cost.evaluate(segs)
        first = segs[0].resource
        input_comm = 0.0 if first == cost.source else cost.comm(
            cost.source, first, cost.batch_input_bytes)
        stage_t = [sum(block_time(s.resource, j)
                       for j in range(s.start, s.end + 1)) for s in segs]
        hops = [cost.comm(a.resource, b.resource,
                          float(cost.out_bytes[a.end]))
                for a, b in zip(segs, segs[1:])]
        want_latency = input_comm + sum(stage_t) + sum(hops)
        desc = " | ".join(f"{s.resource}:{s.start}-{s.end}" for s in segs)
        if not _close(cfg.latency_s, want_latency):
            diags.append(Diagnostic(
                "SCN407", ERROR,
                f"evaluate([{desc}]) reports latency {cfg.latency_s:.6g}s "
                f"but input hop + stage times + cut hops sum to "
                f"{want_latency:.6g}s — latency is not additive over this "
                f"placement, voiding the additive DP's exactness",
                subject=desc,
                hint="the cost model diverges from its DB records"))
            continue
        b = max(1, batch)
        periods = ([input_comm / b] if input_comm > 0.0 else [])
        for k, (s, t) in enumerate(zip(segs, stage_t)):
            reps = cost.replicas_for(s.resource)
            periods.append(t / (reps * b))
            if k < len(hops):
                periods.append(hops[k] / b)
        want_bottleneck = max(periods) if periods else cfg.latency_s
        if not _close(cfg.bottleneck_s, want_bottleneck):
            diags.append(Diagnostic(
                "SCN407", ERROR,
                f"evaluate([{desc}]) reports bottleneck "
                f"{cfg.bottleneck_s:.6g}s but the max over effective "
                f"stage periods is {want_bottleneck:.6g}s — the "
                f"bottleneck does not max-compose, voiding the minimax "
                f"DP's exactness", subject=desc,
                hint="the cost model diverges from its DB records"))
    return diags


def lint_cost(db, network=None, resources: Sequence[str] | None = None,
              cost=None) -> list[Diagnostic]:
    """The full SCN4xx pass: DB + network checks, plus the composition
    check when a cost model is supplied."""
    diags = lint_cost_db(db, network=network, resources=resources)
    if cost is not None:
        diags.extend(lint_cost_model(cost))
    return diags
