"""Pre-solve plan linter (SCN1xx): Query × Constraints × fleet × network.

The lattices and the exhaustive strategy are deliberately silent about
*why* a query is infeasible — an unsatisfiable constraint set yields ``[]``
from every solver (matching the oracle).  This module explains those
empties before (or after) the solve ever runs:

* :func:`lint_plan` — cheap structural checks over the query against the
  fleet, the benchmark DB and the network model.  Each finding is an
  itemized, coded :class:`Diagnostic` (contradictory must_use/exclude,
  impossible floors, caps below every single-block time, tier collisions,
  one-way links, ...).
* :func:`feasible_exists` — an exact chain-feasibility DP over (pipeline,
  cut positions) mirroring the engine's ``_config_satisfies`` semantics.
  Sound and complete on the same search space the solvers range over, so
  when no itemized check fires it still proves joint unsatisfiability
  (SCN109) — the backstop that makes "empty result ⇒ error diagnostic"
  a theorem rather than a heuristic.

``QueryEngine.run`` / ``frontier`` attach the combined findings to
``QueryResult.diagnostics`` (the deep DP only runs on empty results that
no itemized error already explains).

The module is import-light on purpose: ``repro_torch.core`` is imported lazily
inside functions, so ``core`` modules may import this one without cycles.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

from .diagnostics import Diagnostic, ERROR, WARNING, has_errors

# feasible_exists() gives up (returns None) beyond this many candidate
# pipelines — fleet-sized spaces get their explanation from the itemized
# checks only, never from an exponential sweep
MAX_PIPELINES = 50_000


def _fmt_s(t: float) -> str:
    return f"{t * 1e3:.3f}ms"


# ---------------------------------------------------------------------------
# structural checks
# ---------------------------------------------------------------------------

def lint_plan(query: Any, resources: Sequence[Any], network: Any = None,
              db: Any = None, *, source: str | None = None,
              batches: Sequence[int] | None = None,
              check_top_n: bool = True) -> list[Diagnostic]:
    """Structural lint of one query against a fleet.

    ``query`` is duck-typed (a ``repro_torch.core.Query`` or anything with the
    same constraint fields); ``db`` (a ``BenchmarkDB``) enables the
    block-count and timing checks; ``batches`` are the operating points the
    caller will price (an error that needs timing data is only emitted when
    it holds at *every* batch, matching frontier semantics).
    """
    diags: list[Diagnostic] = []
    names = {r.name for r in resources}
    order = {r.name: r.order for r in resources}
    bench = names & set(db.records) if db is not None else set(names)
    n_blocks = db.n_blocks if db is not None else None
    batches = [int(b) for b in (batches or (getattr(query, "batch_size", 1),))]

    must = tuple(getattr(query, "must_use", ()))
    excl = set(getattr(query, "exclude", ()))
    pin = dict(getattr(query, "pin", {}) or {})
    caps = dict(getattr(query, "max_resource_time", {}) or {})
    floors = {r: int(k) for r, k in
              (getattr(query, "min_blocks_on", {}) or {}).items()}
    demanded = list(dict.fromkeys(
        [*must, *(r for r, k in floors.items() if k >= 1)]))

    if check_top_n and getattr(query, "top_n", 1) <= 0:
        diags.append(Diagnostic(
            "SCN112", ERROR,
            f"top_n={query.top_n} requests an empty result by construction",
            hint="ask for top_n >= 1"))

    # SCN101 — direct contradictions
    for r in sorted(set(must) & excl):
        diags.append(Diagnostic(
            "SCN101", ERROR,
            f"resource {r!r} is in both must_use and exclude", subject=r,
            hint="drop it from one of the two lists"))
    for r in sorted({r for r in floors if floors[r] >= 1} & excl):
        diags.append(Diagnostic(
            "SCN101", ERROR,
            f"excluded resource {r!r} has a min_blocks_on floor of "
            f"{floors[r]} (a floor >= 1 demands presence)", subject=r,
            hint="drop the exclusion or the floor"))
    for b, r in sorted(pin.items()):
        if r in excl:
            diags.append(Diagnostic(
                "SCN101", ERROR,
                f"block {b} is pinned to excluded resource {r!r}", subject=r,
                hint="drop the exclusion or move the pin"))

    # SCN102 — unknown / un-benchmarked names
    def check_name(r: str, where: str, hard: bool) -> bool:
        if r in bench:
            return True
        what = "not benchmarked" if r in names else "unknown"
        diags.append(Diagnostic(
            "SCN102", ERROR if hard else WARNING,
            f"{where} names {what} resource {r!r}", subject=r,
            hint="benchmark it first, or fix the name"
            if r in names else "fix the name (no such resource in the fleet)"))
        return False

    for r in demanded:
        check_name(r, "must_use/min_blocks_on", hard=True)
    for b, r in sorted(pin.items()):
        check_name(r, f"pin of block {b}", hard=True)
    for r in sorted(excl):
        if r not in names:
            check_name(r, "exclude", hard=False)
    for r in sorted(caps):
        if r not in names:
            check_name(r, "max_resource_time", hard=False)
    for r in sorted(getattr(query, "replicas", {}) or {}):
        if r not in names:
            check_name(r, "replicas", hard=False)
    for pair in sorted(getattr(query, "max_link_bytes", {}) or {}):
        for r in pair:
            if r not in names and r != (source or ""):
                check_name(r, f"max_link_bytes[{pair}]", hard=False)

    # SCN103 / SCN104 — block-count arithmetic
    if n_blocks is not None:
        for r, k in sorted(floors.items()):
            if k > n_blocks:
                diags.append(Diagnostic(
                    "SCN103", ERROR,
                    f"min_blocks_on floor {k} on {r!r} exceeds the model's "
                    f"{n_blocks} blocks", subject=r,
                    hint=f"the floor can be at most {n_blocks}"))
        present = [r for r in demanded if r in bench]
        need = sum(max(1, floors.get(r, 1)) for r in present)
        if need > n_blocks and \
                all(floors.get(r, 1) <= n_blocks for r in present):
            diags.append(Diagnostic(
                "SCN104", ERROR,
                f"the demanded resources ({', '.join(present)}) need at "
                f"least {need} blocks between them but the model has only "
                f"{n_blocks}",
                hint="relax a floor or drop a must_use entry"))

    # SCN106 — tier collisions among demanded resources, pin-order sanity
    tier_of: dict[int, str] = {}
    for r in demanded:
        if r not in order:
            continue
        prev = tier_of.setdefault(order[r], r)
        if prev != r:
            diags.append(Diagnostic(
                "SCN106", ERROR,
                f"demanded resources {prev!r} and {r!r} share a tier; a "
                "pipeline holds at most one resource per tier", subject=r,
                hint="demand at most one resource per tier"))
    pins = sorted((int(b), r) for b, r in pin.items() if r in order)
    for b, r in pins:
        if n_blocks is not None and not 0 <= b < n_blocks:
            diags.append(Diagnostic(
                "SCN106", ERROR,
                f"pin targets block {b}, outside the model's blocks "
                f"0..{n_blocks - 1}", subject=r,
                hint="fix the block index"))
    for (b1, r1), (b2, r2) in zip(pins, pins[1:]):
        if r1 == r2:
            continue
        if order[r1] > order[r2]:
            diags.append(Diagnostic(
                "SCN106", ERROR,
                f"pins violate tier order: block {b1} on {r1!r} "
                f"(tier {order[r1]}) precedes block {b2} on {r2!r} "
                f"(tier {order[r2]}) but data flows device -> edge -> "
                "cloud", subject=r2,
                hint="pin earlier blocks to earlier tiers"))
        elif order[r1] == order[r2]:
            diags.append(Diagnostic(
                "SCN106", ERROR,
                f"blocks {b1} and {b2} are pinned to different resources "
                f"({r1!r}, {r2!r}) on the same tier; a pipeline holds at "
                "most one resource per tier", subject=r2,
                hint="pin both to one resource, or to different tiers"))

    # SCN105 — compute-time caps below every single-block time
    if db is not None:
        for r, cap in sorted(caps.items()):
            if r not in bench or r in excl:
                continue
            if all(min(db.time(r, b, batch) for b in range(n_blocks)) > cap
                   for batch in batches):
                hard = r in demanded
                diags.append(Diagnostic(
                    "SCN105", ERROR if hard else WARNING,
                    f"max_resource_time {_fmt_s(cap)} on {r!r} is below "
                    "every single-block time"
                    + ("" if len(batches) == 1
                       else " at every swept batch size")
                    + (" — no feasible configuration can use it" if hard
                       else f" — {r!r} can never host a block"),
                    subject=r,
                    hint="raise the cap or drop the resource instead"))
        for b, r in pins:
            cap = caps.get(r)
            if cap is None or r not in bench or not (
                    n_blocks is not None and 0 <= b < n_blocks):
                continue
            if all(db.time(r, b, batch) > cap for batch in batches):
                diags.append(Diagnostic(
                    "SCN105", ERROR,
                    f"block {b} is pinned to {r!r} but its single-block "
                    f"time already exceeds the {_fmt_s(cap)} cap",
                    subject=r, hint="raise the cap or move the pin"))

    # SCN108 — the pipelines restriction (or blanket exclusion) admits none
    if names and names <= excl:
        diags.append(Diagnostic(
            "SCN108", ERROR,
            "every fleet resource is excluded: no pipeline can be formed",
            hint="keep at least one resource admissible"))
    restriction = getattr(query, "pipelines", None)
    if restriction is not None:
        valid = [tuple(p) for p in restriction
                 if all(n in order for n in p)
                 and all(order[a] < order[b] for a, b in zip(p, p[1:]))]
        dset = set(demanded)
        admissible = [p for p in valid
                      if not (dset - set(p)) and not (set(p) & excl)]
        if not admissible:
            why = "no pipeline is tier-ordered over known resources" \
                if not valid else \
                "every valid pipeline misses a demanded resource or " \
                "contains an excluded one"
            diags.append(Diagnostic(
                "SCN108", ERROR,
                f"the pipelines restriction admits no valid pipeline: {why}",
                hint="list pipelines in strictly ascending tier order and "
                     "keep them consistent with must_use/exclude"))

    # SCN107 / SCN110 — network introspection (needs NetworkModel.links())
    links = network.links() if network is not None \
        and hasattr(network, "links") else None
    if links is not None:
        forced: list[tuple[str, str]] = []
        if source and 0 in pin and pin[0] != source:
            forced.append((source, pin[0]))
        for (b1, r1), (b2, r2) in zip(pins, pins[1:]):
            if b2 == b1 + 1 and r1 != r2:
                forced.append((r1, r2))
        for src, dst in forced:
            if (src, dst) not in links:
                diags.append(Diagnostic(
                    "SCN107", WARNING,
                    f"pinned hop {src!r} -> {dst!r} has no explicit link; "
                    "the default link prices it", subject=f"{src}->{dst}",
                    hint="connect() the pair explicitly if the default "
                         "does not describe this hop"))
        for (a, b) in sorted(links):
            if a == b or (b, a) in links:
                continue
            if a in order and b in order and order[b] < order[a]:
                # the explicit link points against the data-flow direction;
                # the direction the planner can actually use falls back
                diags.append(Diagnostic(
                    "SCN110", WARNING,
                    f"one-way link {a!r} -> {b!r}: the planner-usable "
                    f"direction {b!r} -> {a!r} silently falls back to the "
                    "default link", subject=f"{b}->{a}",
                    hint="connect(src, dst, link) with symmetric=True, or "
                         "add the reverse direction explicitly"))
    return diags


# ---------------------------------------------------------------------------
# exact chain-feasibility backstop (SCN109)
# ---------------------------------------------------------------------------

def _candidate_pipelines(resources: Sequence[Any],
                         restriction: Iterable[Sequence[str]] | None,
                         limit: int = MAX_PIPELINES
                         ) -> list[tuple[str, ...]] | None:
    """The pipeline set a query ranges over, or ``None`` when it would
    exceed ``limit`` (fleet-sized spaces: the DP declines to run)."""
    order = {r.name: r.order for r in resources}
    if restriction is not None:
        pipes = [tuple(p) for p in restriction
                 if all(n in order for n in p)
                 and all(order[a] < order[b] for a, b in zip(p, p[1:]))]
        return None if len(pipes) > limit else pipes
    tiers: dict[int, list[str]] = {}
    for r in sorted(resources, key=lambda r: r.order):
        tiers.setdefault(r.order, []).append(r.name)
    total = 1
    for lvl in tiers.values():
        total *= len(lvl) + 1
    if total - 1 > limit:
        return None
    from ..core.partition import ordered_pipelines
    return ordered_pipelines(list(resources))


def _pipe_feasible(cost: Any, cons: Any, pipe: tuple[str, ...]) -> bool:
    """Exact DP over cut positions: can blocks 0..B-1 be split into
    ``len(pipe)`` contiguous segments hosted by ``pipe`` in order, under
    every constraint?  Mirrors ``QueryEngine._config_satisfies`` bit for
    bit (``allowed`` covers exclude+pin, ``transition_allowed`` the link
    caps, ``segment_time`` the compute-time caps, floors at close)."""
    B = cost.n_blocks
    k = len(pipe)
    if k > B:
        return False
    if pipe[0] != cost.source and not cons.transition_allowed(
            cost.source, pipe[0], cost.batch_input_bytes):
        return False
    starts = {0}
    for j, r in enumerate(pipe):
        last = j == k - 1
        cap = cons.max_resource_time.get(r)
        floor = cons.min_blocks_on.get(r, 0)
        nxt: set[int] = set()
        for b in sorted(starts):
            e_max = B - 1 - (k - 1 - j)
            for e in range(b, e_max + 1):
                if not cons.allowed(e, r):
                    break               # contiguity: no later e works either
                if cap is not None and cost.segment_time(r, b, e) > cap:
                    break               # segment time is monotone in e
                if e - b + 1 < floor:
                    continue
                if last:
                    if e == B - 1:
                        return True
                    continue
                if cons.transition_allowed(r, pipe[j + 1],
                                           float(cost.out_bytes[e])):
                    nxt.add(e + 1)
        if last:
            return False
        starts = nxt
        if not starts:
            return False
    return False


def feasible_exists(cost: Any, cons: Any,
                    pipelines: Iterable[Sequence[str]] | None = None,
                    limit: int = MAX_PIPELINES) -> bool | None:
    """Whether any configuration satisfies ``cons`` at ``cost``'s operating
    point — exactly the exhaustive strategy's feasible set being non-empty.
    Returns ``None`` (unknown) when the pipeline space exceeds ``limit``.
    """
    pipes = _candidate_pipelines(cost.resources, pipelines, limit)
    if pipes is None:
        return None
    demanded = set(cons.must_use) | {
        r for r, n in cons.min_blocks_on.items() if n >= 1}
    pinned = set(cons.pin.values())
    for pipe in pipes:
        members = set(pipe)
        if demanded - members or (members & cons.exclude) \
                or (pinned - members):
            continue
        if _pipe_feasible(cost, cons, pipe):
            return True
    return False


def explain_empty(query: Any, cons: Any, costs: Sequence[Any],
                  prior: Sequence[Diagnostic] = ()) -> list[Diagnostic]:
    """The SCN109 backstop for an empty result: prove (exactly) that the
    constraints are jointly unsatisfiable at *every* priced operating
    point.  Skipped when an itemized error in ``prior`` already explains
    the empty, or when the space is too large to sweep."""
    if has_errors(list(prior)):
        return []
    restriction = getattr(query, "pipelines", None)
    for cost in costs:
        verdict = feasible_exists(cost, cons, pipelines=restriction)
        if verdict is None or verdict:
            return []
    points = "" if len(costs) == 1 else \
        f" at every swept operating point ({len(costs)} batch sizes)"
    return [Diagnostic(
        "SCN109", ERROR,
        "the constraints are jointly unsatisfiable: an exact sweep over "
        f"every (pipeline, cut) combination found no feasible "
        f"configuration{points}",
        hint="relax one constraint at a time (caps and floors interact "
             "with pins and link limits) and re-run the linter")]
