"""Table I in the port: the 18 DNNs — layer counts, partition points,
linear/branching classification — with their FLOPs and parameter bytes.

    PYTHONPATH=src python -m benchmarks.bench_zoo_torch

Structure does not depend on where the weights live; ``device="meta"``
builds the nets without weights.
"""

from __future__ import annotations

import time

from repro_torch.core import fuse_blocks
from repro_torch.models import cnn_zoo


def run(quick: bool = True, device: str = "cuda"):
    names = (["VGG16", "ResNet50", "MobileNet", "MobileNetV2",
              "DenseNet121", "InceptionV3"] if quick
             else sorted(cnn_zoo.ZOO))
    rows = []
    print("\n# Table I — model zoo (layers / partition points / type)")
    print(f"{'model':<20}{'layers':>8}{'points':>8}{'type':>6}{'approx':>8}"
          f"{'GFLOP':>9}{'params MB':>11}")
    for name in names:
        t0 = time.perf_counter()
        g = cnn_zoo.build(name, device)
        blocks = fuse_blocks(g)
        dt = time.perf_counter() - t0
        typ = "L" if name in cnn_zoo.LINEAR else "B"
        flops = sum(b.flops for b in blocks)
        params = sum(b.param_bytes for b in blocks)
        print(f"{name:<20}{g.n_layers:>8}{len(blocks) - 1:>8}{typ:>6}"
              f"{'~' if name in cnn_zoo.APPROX else '':>8}"
              f"{flops / 1e9:>9.2f}{params / 1e6:>11.1f}")
        rows.append((f"zoo/{name}", dt * 1e6, len(blocks) - 1))
        del g, blocks
    return rows


if __name__ == "__main__":
    run(quick=False)
