"""The margin of the 3G/4G decision flip on the card: MobileNetV2's
BenchmarkDB timed afresh ``repeats`` times (Steps 1-3 of
``examples/quickstart_torch.py``, no cache) and queried under 3G and 4G at
``common_torch.TIME_SCALE`` each time.

    PYTHONPATH=src python -m benchmarks.bench_flip_torch [--repeats N]

Per repeat: each tier's whole-model time (its block times over its speed
factor) and their median, the calibration's statistic; the best partition
under 3G and under 4G; whether the flip holds; and the network scale factors
over which it holds.  The constant is not touched: this reads how far the
card's timing noise moves the decision that the calibration fixed.
"""

from __future__ import annotations

import argparse
import statistics

from benchmarks import common_torch as ct
from repro_torch.core import Query
from repro_torch.models import cnn_zoo


def run(repeats: int = 10, device: str = "cuda") -> list[dict]:
    print(f"card: {ct.card_line()}; flags {ct.fp32_flags()}; TIME_SCALE "
          f"{ct.TIME_SCALE:.6g}")
    s3, s4 = ct.scission_for("3g", device=device), \
        ct.scission_for("4g", device=device)
    graph = cnn_zoo.build("MobileNetV2", s3.device)
    rows = []
    for i in range(repeats):
        db = s3.benchmark(graph)
        s4.load(db)
        tiers = ct.tier_times(db, s3.resources)
        best = {n: s.query("MobileNetV2", Query(top_n=1)).best
                for n, s in (("3g", s3), ("4g", s4))}
        lo, hi = ct.flip_range(db, s3.resources)
        row = dict(median_ms=statistics.median(tiers.values()) * 1e3,
                   tiers_ms={k: v * 1e3 for k, v in tiers.items()},
                   flips=ct.flips(best["3g"], best["4g"]), lo=lo, hi=hi,
                   best_3g=best["3g"].describe(),
                   best_4g=best["4g"].describe())
        rows.append(row)
        print(f"repeat {i}: median {row['median_ms']:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in row["tiers_ms"].items())
              + f"); flip {'holds' if row['flips'] else 'fails'}, range "
              f"{lo:.4g}-{hi:.4g}; 3G {row['best_3g']}; 4G {row['best_4g']}")
    meds = [r["median_ms"] for r in rows]
    print(f"flip held in {sum(r['flips'] for r in rows)} of {len(rows)}; "
          f"median tier time {min(meds):.4f}-{max(meds):.4f} ms, median "
          f"{statistics.median(meds):.4f} ms (the calibration took "
          f"{ct.CARD_MOBILENETV2_S * 1e3:.4f} ms)")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=10)
    run(ap.parse_args().repeats)
