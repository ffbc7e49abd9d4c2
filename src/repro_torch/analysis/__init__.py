"""scission-lint for the port: kernel, plan, graph, cost-model and
dataflow checks.

* :mod:`repro_torch.analysis.kernel_smem` (SCN201-203) — per-CTA shared
  memory of the Hopper kernels' candidates against the card's limit;
  feeds the autotuner's pre-timing prune.
* :mod:`repro_torch.analysis.tiling` (SCN204-207) — Hopper tile alignment
  and the launches' refusals; feeds the autotuner's ``tile_check`` and
  ``adopt_tuned_params``.
* :mod:`repro_torch.analysis.plan_lint` (SCN1xx) — pre-solve
  query/constraint linting plus the exact joint-satisfiability backstop;
  feeds ``QueryResult.diagnostics``.
* :mod:`repro_torch.analysis.graph_lint` (SCN3xx) — LayerGraph IR
  well-formedness; feeds ``LayerGraph.validate``.
* :mod:`repro_torch.analysis.cost_lint` (SCN4xx) — cost-model soundness.
* :mod:`repro_torch.analysis.fx_lint` (SCN5xx) — the FX dataflow lint of
  fused blocks.

``python -m repro_torch.analysis`` (:mod:`repro_torch.analysis.cli`) runs
them.  Only the diagnostics vocabulary is exported eagerly, so
``repro_torch.core`` modules can depend on this package without cycles.
"""

from .diagnostics import (CODES, Diagnostic, ERROR, INFO, WARNING, dedupe,
                          errors, has_errors, render_report,
                          sort_by_severity)

__all__ = [
    "CODES", "Diagnostic", "ERROR", "INFO", "WARNING", "dedupe", "errors",
    "has_errors", "render_report", "sort_by_severity",
]
