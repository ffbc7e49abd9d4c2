"""scission-lint for the port: plan, cost-model and graph checks.

* :mod:`repro_torch.analysis.plan_lint` (SCN1xx) — pre-solve
  query/constraint linting plus the exact joint-satisfiability backstop;
  feeds ``QueryResult.diagnostics``.
* :mod:`repro_torch.analysis.cost_lint` (SCN4xx) — cost-model soundness.
* :mod:`repro_torch.analysis.graph_lint` (SCN3xx) — LayerGraph IR
  well-formedness; feeds ``LayerGraph.validate``.

Only the diagnostics vocabulary is exported eagerly, so ``repro_torch.core``
modules can depend on this package without cycles.
"""

from .diagnostics import (CODES, Diagnostic, ERROR, INFO, WARNING, dedupe,
                          errors, has_errors, render_report,
                          sort_by_severity)

__all__ = [
    "CODES", "Diagnostic", "ERROR", "INFO", "WARNING", "dedupe", "errors",
    "has_errors", "render_report", "sort_by_severity",
]
