"""Serving the published Zamba2: ``paths/serve.py``'s runner with the
Zamba2 reference (``reference/zamba2.py``) in the place of
``reference/lm.py`` for the output check, and, in a traced run, a
``pb:ssd_scan`` range around each of the prefill's ``ssd_scan`` calls (as
``paths/train.py`` wraps them), its work counted by ``ssd_work``: each
group's B and C read once.  The record also carries ``n_applied``, the
parameters a token applies: each shared block counted once for each of
its applications, where ``n_params`` counts it once (read by
``mfu_applied.*``).

The serving runner is loaded as a module of its own
(``harness.files.path_module``), so the reference is replaced there and
nowhere else.
"""

from __future__ import annotations

from harness import files
from harness import model as port
from harness import weights
from harness.trace import patched
from harness.work import ssd_work
from reference import zamba2 as ref

_serve = files.path_module("serve")
_serve.ref = ref
_layer_spans = _serve._layer_spans


def _spans_with_ssd(eng, spans, state):
    from repro_torch.models import ssm

    def scan(a, kw, out):
        f, b = ssd_work(a[0], a[1], a[2], a[3], out[0], out[1])
        return {"flops": f, "bytes": b}

    return _layer_spans(eng, spans, state) + [
        patched(ssm, "ssd_scan",
                spans.wrap("ssd_scan", ssm.ssd_scan, work=scan))]


_serve._layer_spans = _spans_with_ssd
logit_gaps = _serve.logit_gaps


def applied_params(run) -> int:
    """The port's parameters with each of the ``n_shared_blocks`` blocks
    counted once for each of its applications, as a token's forward pass
    applies them."""
    model, cfg = port.build(run)
    spec = model.spec()
    block = weights.count(spec["shared_blocks"]) // cfg.n_shared_blocks
    return weights.count(spec) + block * (cfg.n_shared_applications
                                          - cfg.n_shared_blocks)


def run(run) -> dict:
    out = _serve.run(run)
    out["record"]["n_applied"] = applied_params(run)
    return out
