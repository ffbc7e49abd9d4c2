"""Quickstart of the port: Scission end-to-end on MobileNetV2 on the card
(the paper's Figure 8).

    PYTHONPATH=src python examples/quickstart_torch.py

Benchmarks the model on the emulated device/edge/cloud testbed with the card
playing the cloud box (Steps 1-3, cached per device under
``results/benchdb_torch``), then queries the optimal partition under 3G and
4G (Steps 4-6) — the paper's headline result is that the optimum flips from
device-native under 3G to cloud-native under 4G; on the card, at the
calibration of ``benchmarks/common_torch.py``, 4G picks a split partition
instead (PERF.md §5) — and the best partition that keeps the data off the
cloud.
"""

import sys

sys.path.insert(0, "src")
sys.path.insert(0, ".")

from benchmarks.common_torch import (benchmark_cached, card_line,  # noqa: E402
                                     fp32_flags, scission_for)
from repro_torch.core import Query  # noqa: E402


def main():
    print("== Scission quickstart (PyTorch port): MobileNetV2 on "
          "device/edge/cloud ==")
    print(f"card: {card_line()}; flags {fp32_flags()}")
    for net in ("3g", "4g"):
        s = scission_for(net)
        print(f"\n[{net}] benchmarking (Steps 1-3, cached after first run)…")
        benchmark_cached(s, "MobileNetV2")
        res = s.query("MobileNetV2", Query(top_n=3))
        print(f"[{net}] top-3 partitions "
              f"(query took {res.query_time_s * 1e3:.1f}ms):")
        for cfg in res.configs:
            print("   ", cfg.describe())

    # a constrained query: keep data on the device+edge (privacy)
    s = scission_for("4g")
    benchmark_cached(s, "MobileNetV2")
    res = s.query("MobileNetV2",
                  Query(top_n=1, exclude=("cloud", "cloud_gpu")))
    print("\n[4g, privacy: no cloud]", res.best.describe())


if __name__ == "__main__":
    main()
