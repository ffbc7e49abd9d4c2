"""Resource tiers and device models (Scission Table II).

A :class:`Resource` is one benchmarking/execution target: the paper's
Raspberry Pi device, the two edge boxes, the cloud VM (with and without
GPU).  Each resource carries a :class:`DeviceModel` used by the analytic
benchmark provider; the timing provider ignores the model and measures
wall-clock on this host's device (scaled by ``speed_factor`` so the
heterogeneous-tier experiments remain meaningful on a single machine,
exactly like the paper's emulated network conditions).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DeviceModel:
    """Roofline-style device description.

    ``effective_flops`` is sustained (not peak datasheet) throughput for the
    dominant dtype; ``mem_bw`` is sustained memory bandwidth; ``dispatch_s``
    is the fixed per-layer launch overhead (interpreter + runtime), which the
    paper's per-layer benchmarking implicitly captures and which matters for
    many-layer models like NASNet.
    """

    name: str
    effective_flops: float          # FLOP/s
    mem_bw: float                   # bytes/s
    dispatch_s: float = 20e-6       # per-layer fixed overhead

    def layer_time(self, flops: float, bytes_moved: float) -> float:
        """max(compute, memory) roofline + dispatch."""
        t_compute = flops / self.effective_flops if self.effective_flops else 0.0
        t_memory = bytes_moved / self.mem_bw if self.mem_bw else 0.0
        return max(t_compute, t_memory) + self.dispatch_s


@dataclass(frozen=True)
class Resource:
    """One target in the device/edge/cloud continuum."""

    name: str
    tier: str                       # "device" | "edge" | "cloud"
    device: DeviceModel
    # Multiplier applied to wall-clock times measured on *this* host by the
    # timing provider to emulate the resource (this host plays the role of
    # the paper's 'Cloud' box; slower tiers get factors > 1).
    speed_factor: float = 1.0
    # Tier ordering for pipeline construction: data flows device -> edge -> cloud.
    order: int = field(default=0)

    def __post_init__(self):
        order = {"device": 0, "edge": 1, "cloud": 2}[self.tier]
        object.__setattr__(self, "order", order)


# ---------------------------------------------------------------------------
# Device models.  CPU numbers are sustained-GEMM estimates for the paper's
# hardware (Table II); they only feed the *analytic* provider — the faithful
# reproduction path measures wall-clock instead.
# ---------------------------------------------------------------------------

# sustained throughput calibrated against reported Pi4 CNN inference times
# (MobileNetV2 ~0.2-0.5 s, ResNet50 ~1-2 s on TF), not the datasheet peak
RPI4 = DeviceModel("rpi4-armv8", effective_flops=1.5e9, mem_bw=1.5e9,
                   dispatch_s=250e-6)
EDGE_BOX_1 = DeviceModel("edge1-2c-4.5ghz", effective_flops=5.5e10, mem_bw=2.0e10,
                         dispatch_s=60e-6)
EDGE_BOX_2 = DeviceModel("edge2-4c-3.7ghz", effective_flops=7.0e10, mem_bw=2.5e10,
                         dispatch_s=60e-6)
CLOUD_VM = DeviceModel("cloud-8c-4.5ghz", effective_flops=1.8e11, mem_bw=4.0e10,
                       dispatch_s=40e-6)
GTX_1070 = DeviceModel("gtx1070", effective_flops=5.0e12, mem_bw=2.56e11,
                       dispatch_s=30e-6)

# The card the port runs on.  Not sustained rates, which no run has
# measured yet: NVIDIA's data-sheet peaks of the H100 SXM at its 700 W power
# limit, float32 outside the tensor cores (the zoo runs in fp32 with TF32
# off) and HBM3.  ``dispatch_s`` keeps the class default, unmeasured.
H100_SXM = DeviceModel("h100-sxm", effective_flops=67e12, mem_bw=3.35e12)


# -- the paper's testbed (Table II) -----------------------------------------

def paper_testbed() -> list[Resource]:
    return [
        Resource("device", "device", RPI4, speed_factor=30.0),
        Resource("edge1", "edge", EDGE_BOX_1, speed_factor=3.3),
        Resource("edge2", "edge", EDGE_BOX_2, speed_factor=2.6),
        Resource("cloud", "cloud", CLOUD_VM, speed_factor=1.0),
        Resource("cloud_gpu", "cloud", GTX_1070, speed_factor=0.03),
    ]


def by_name(resources: list[Resource]) -> dict[str, Resource]:
    return {r.name: r for r in resources}
