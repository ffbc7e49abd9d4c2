"""Table III in the port: Scission's benchmarking overhead per DNN per
resource (seconds to run Steps 2-3 on one resource).

    PYTHONPATH=src python -m benchmarks.bench_overhead_torch

Each net is built on ``device`` and its blocks are timed on each tier of
``common_torch.testbed`` alone by ``TimingProvider`` (on the card: a warm-up,
a CUDA-graph capture and five replays per block); the wall time of that
step, times the tier's speed factor, is the emulated overhead.  The row's
derived value is the device/cloud overhead ratio (the paper reports ~10x).
"""

from __future__ import annotations

import time

from repro_torch._device import resolve_device
from repro_torch.core import TimingProvider, benchmark_model
from repro_torch.models import cnn_zoo

from .common_torch import fp32_flags, testbed


def run(quick: bool = True, device: str = "cuda"):
    dev = resolve_device(device)
    fp32_flags()
    names = (["MobileNetV2", "ResNet50", "VGG16"] if quick
             else ["Xception", "VGG16", "VGG19", "ResNet50", "MobileNet",
                   "MobileNetV2", "DenseNet121", "InceptionV3"])
    resources = testbed()
    rows = []
    print("\n# Table III — benchmarking overhead (s) per resource")
    hdr = f"{'model':<16}" + "".join(f"{r.name:>11}" for r in resources)
    print(hdr)
    for name in names:
        g = cnn_zoo.build(name, dev)
        times = []
        for r in resources:
            t0 = time.perf_counter()
            benchmark_model(g, [r], TimingProvider(device=dev), runs=5)
            wall = time.perf_counter() - t0
            # emulated overhead: measurement wall-time scaled to the tier
            times.append(wall * r.speed_factor)
        print(f"{name:<16}" + "".join(f"{t:>11.2f}" for t in times))
        rows.append((f"overhead/{name}", times[-2] * 1e6,
                     round(times[0] / times[-2], 2)))
        # derived: device/cloud overhead ratio (paper: ~10x)
        del g
    return rows


if __name__ == "__main__":
    run(quick=False)
