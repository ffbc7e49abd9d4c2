"""§Roofline report over the port's dry-run artifact
(``results/dryrun_torch.json``), with the H100's constants
(``repro_torch.launch.roofline``)."""

from __future__ import annotations

import json
import os

from repro_torch.launch.roofline import analyse, table

RESULTS = os.path.join(os.path.dirname(__file__), "..", "results",
                       "dryrun_torch.json")


def run(quick: bool = True, path: str = RESULTS):
    if not os.path.exists(path):
        print("\n# Roofline: results/dryrun_torch.json missing — run "
              "`python -m repro_torch.launch.dryrun --all --out "
              "results/dryrun_torch.json` first")
        return []
    with open(path) as f:
        records = json.load(f)
    print("\n# §Roofline — single-pod 16x16 (from the dry-run)")
    print(table(records, "16x16"))
    rows = []
    for r in records:
        if r["status"] != "OK" or r["mesh"] != "16x16":
            continue
        a = analyse(r)
        dom_ms = max(a["t_compute_s"], a["t_memory_s"],
                     a["t_collective_s"]) * 1e3
        rows.append((f"roofline/{r['arch']}/{r['shape']}", dom_ms * 1e3,
                     round(a["roofline_fraction"], 4)))
    return rows


if __name__ == "__main__":
    run()
