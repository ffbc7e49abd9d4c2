#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

``NAME`` is an entry of ``BENCHMARK.json``'s ``workloads``; its files are
``perfbench/workloads/NAME.json`` and the configuration and path that file
names.  The last line of standard output is the result as one JSON object;
the numbers that decide ``correct`` are the last lines of standard error.
See ``perfbench/README.md``.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _since_process_start() -> float:
    """Seconds since this process started, from ``/proc`` (10 ms ticks);
    0 where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


if __name__ == "__main__":
    t_top = time.perf_counter()
    before_top = _since_process_start()
    # the program's kernel caches live at fixed paths inside the checkout,
    # set before torch is imported (the CUDA kernels' own build cache is
    # ``build/repro_torch_kernels/<hash>/``, inside the checkout too)
    cache = os.path.join(ROOT, "build", "perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [HERE, os.path.join(ROOT, "src")]
    from harness.cli import main
    sys.exit(main(sys.argv[1:], process_start=t_top - before_top))
