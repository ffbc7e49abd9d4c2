"""Shared diagnostic type for the static-analysis layer (``scission-lint``).

Every analyzer — the plan linter (SCN1xx), the kernel memory / tiling
analyzers (SCN2xx), the graph IR checker (SCN3xx), the cost-model
soundness pass (SCN4xx) and the FX dataflow lint (SCN5xx) — reports
findings as
:class:`Diagnostic` values: a stable machine-checkable ``code``, a
``severity``, a human message, the ``subject`` the finding is about (a
resource name, a kernel candidate, a graph node) and an actionable
``hint``.  Engine surfaces attach them (``QueryResult.diagnostics``),
exceptions carry them (:class:`repro_torch.analysis.graph_lint.GraphLintError`)
and the CLI renders them, so one representation serves programmatic and
human consumers alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Severities, ordered: an ``error`` means the subject cannot work (an
# infeasible plan, a kernel over the card's shared memory, a malformed graph); a ``warning``
# means it works but probably not as intended (silent fallback, invisible
# clamp); ``info`` is advisory context (e.g. which candidates were pruned).
ERROR = "error"
WARNING = "warning"
INFO = "info"
_SEVERITY_RANK = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclass(frozen=True)
class Diagnostic:
    """One static-analysis finding.

    ``code`` is stable across releases (``SCN1xx`` plan, ``SCN2xx`` kernel,
    ``SCN3xx`` graph — see :data:`CODES`); ``subject`` names the entity the
    finding is about so tools can key on (code, subject) pairs.
    """

    code: str
    severity: str
    message: str
    subject: str = ""
    hint: str = ""

    def __post_init__(self):
        if self.severity not in _SEVERITY_RANK:
            raise ValueError(f"unknown severity {self.severity!r}")
        if not (len(self.code) == 6 and self.code.startswith("SCN")
                and self.code[3:].isdigit()):
            raise ValueError(f"malformed diagnostic code {self.code!r}")

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def render(self) -> str:
        subj = f" [{self.subject}]" if self.subject else ""
        hint = f"\n        hint: {self.hint}" if self.hint else ""
        return f"{self.code} {self.severity}{subj}: {self.message}{hint}"


# The full diagnostic-code table (also rendered in the README).  Codes are
# append-only: a retired check keeps its number reserved.
CODES: dict[str, str] = {
    # -- SCN1xx: plan linter (Query x Constraints x fleet x NetworkModel) ----
    "SCN101": "must_use and exclude name the same resource",
    "SCN102": "constraint names an unknown / un-benchmarked resource",
    "SCN103": "min_blocks_on floor exceeds the model's block count",
    "SCN104": "demanded block floors cannot all fit in the block count",
    "SCN105": "max_resource_time is below every admissible segment time",
    "SCN106": "demanded resources collide on a tier (or pins violate "
              "tier order)",
    "SCN107": "consecutive pinned resources have no explicit link "
              "(default-link fallback)",
    "SCN108": "pipelines restriction admits no valid pipeline",
    "SCN109": "constraints are jointly unsatisfiable (no feasible "
              "configuration exists)",
    "SCN110": "one-way link: reverse direction falls back to the default "
              "link",
    "SCN111": "batch size outside the measured profile range was clamped",
    "SCN112": "top_n <= 0 requests an empty result by construction",
    # -- SCN2xx: kernel shared-memory analysis (per-CTA footprint vs the ----
    # -- card's limit per block, analysis/kernel_smem.py) -------------------
    "SCN201": "kernel candidate statically exceeds the shared memory a CTA "
              "may use",
    "SCN202": "every candidate of a kernel sweep exceeds the shared memory a "
              "CTA may use",
    "SCN203": "unknown kernel: per-CTA shared-memory footprint cannot be "
              "computed statically",
    # -- SCN3xx: graph IR checker (LayerGraph well-formedness) ---------------
    "SCN301": "empty graph",
    "SCN302": "predecessor index is dangling or non-topological",
    "SCN303": "extra sink: a non-final node has no successors",
    "SCN304": "orphan source: a non-input node has no predecessors",
    "SCN305": "non-input node has no apply function",
    "SCN306": "declared out_spec disagrees with the shape computed from "
              "predecessor out_specs",
    "SCN307": "benchmarked output bytes disagree with the graph's computed "
              "output bytes",
    "SCN308": "graph is untraced: shape-chain checks skipped",
    "SCN309": "graph is not series-parallel: non-SP region linearised",
    "SCN310": "series-parallel decomposition failed: chain fallback",
    # -- SCN2xx (cont.): Hopper tile alignment (analysis/tiling.py) ---------
    "SCN204": "kernel candidate block is misaligned to the Hopper kernel's "
              "tiles (padded rows) or refused by its launch",
    "SCN205": "kernel candidate leaves grid-remainder padding waste",
    "SCN206": "every candidate of a kernel sweep is misaligned or refused",
    "SCN207": "row not a whole number of 16-byte pieces, or padded or "
              "refused by the bf16 tensor-core tiles",
    # -- SCN4xx: cost-model soundness (BenchmarkDB x NetworkModel vs the ----
    # -- invariants the exact DPs assume) -----------------------------------
    "SCN401": "non-finite or negative stage time / byte count in the "
              "benchmark DB",
    "SCN402": "batch profile is non-monotone: per-batch time decreases "
              "with batch size",
    "SCN403": "batch-profile coverage gap: resource misses batches other "
              "resources measured",
    "SCN404": "link model anomaly: negative latency or non-positive "
              "bandwidth",
    "SCN405": "asymmetric explicit link pair: a->b and b->a cost differ",
    "SCN406": "self-link staging is costlier than the default "
              "inter-resource link",
    "SCN407": "cost-model composition violated: latency not additive or "
              "bottleneck not max-composing",
    # -- SCN5xx: FX dataflow lint (Block.make_callable traced by make_fx) ---
    "SCN501": "float64 value inside the FX trace of a block (f64 leakage)",
    "SCN502": "traced boundary tensor disagrees with BenchmarkDB / graph "
              "output bytes",
    "SCN503": "host sync inside a block: fails meta tracing, holds a "
              "host-sync op, or cannot be captured in a CUDA graph",
    "SCN504": "sub-f32 output of a contraction in a kernel-bearing block",
}


def errors(diags: list[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def has_errors(diags: list[Diagnostic]) -> bool:
    return any(d.severity == ERROR for d in diags)


def dedupe(diags: list[Diagnostic]) -> list[Diagnostic]:
    """Collapse repeated (code, subject) findings, preserving order — a
    frontier sweep re-derives the same fact once per operating point with
    the batch size baked into the message, so keying on the message would
    let one clamp render dozens of times.  The first message wins."""
    seen: set[tuple[str, str]] = set()
    out = []
    for d in diags:
        k = (d.code, d.subject)
        if k not in seen:
            seen.add(k)
            out.append(d)
    return out


def sort_by_severity(diags: list[Diagnostic]) -> list[Diagnostic]:
    return sorted(diags, key=lambda d: (_SEVERITY_RANK[d.severity], d.code,
                                        d.subject))


def render_report(diags: list[Diagnostic], title: str = "") -> str:
    """Human-readable multi-line report (the CLI's output unit)."""
    lines = []
    if title:
        lines.append(f"== {title} ==")
    if not diags:
        lines.append("  clean (no diagnostics)")
    for d in sort_by_severity(dedupe(diags)):
        lines.append("  " + d.render())
    return "\n".join(lines)
