"""Network link models (Scission §III-A).

The paper's first assumption: ``comm_time = network_latency + bytes /
bandwidth``.  We keep that for every WAN/LAN link and add datacenter links
(ICI within a pod, DCN across pods) for the TPU tiers.  Bandwidth presets
are the paper's emulated conditions.
"""

from __future__ import annotations

from dataclasses import dataclass

Mbps = 1e6 / 8          # bytes/s per megabit-per-second
GBps = 1e9              # bytes/s per gigabyte-per-second


@dataclass(frozen=True)
class Link:
    name: str
    latency_s: float
    bandwidth: float        # bytes / s

    def comm_time(self, nbytes: float) -> float:
        """Paper assumption 1: latency + size/bandwidth."""
        return self.latency_s + nbytes / self.bandwidth


# -- the paper's emulated network conditions ---------------------------------
THREE_G = Link("3g", latency_s=0.067, bandwidth=1.6 * Mbps)
FOUR_G = Link("4g", latency_s=0.055, bandwidth=12.4 * Mbps)
WIRED = Link("wired", latency_s=0.020, bandwidth=20 * Mbps)
EDGE_CLOUD = Link("edge-cloud", latency_s=0.025, bandwidth=50 * Mbps)

# -- datacenter links for the TPU tiers --------------------------------------
ICI = Link("ici", latency_s=1e-6, bandwidth=50 * GBps)       # per link
DCN = Link("dcn", latency_s=10e-6, bandwidth=25 * GBps)      # inter-pod
LOOPBACK = Link("local", latency_s=0.0, bandwidth=float("inf"))


class NetworkModel:
    """Maps ordered resource pairs to links.

    Construction mirrors the paper's experiments: one link class for
    device->edge (3G/4G/wired, the variable under study), one fixed link for
    edge->cloud (25 ms / 50 Mbps), and device->cloud traverses both hops'
    latency but is modelled as the access link (the paper's device-cloud
    numbers use the access-network figures end-to-end).
    """

    def __init__(self, default: Link = EDGE_CLOUD):
        self._links: dict[tuple[str, str], Link] = {}
        self._default = default

    def connect(self, src: str, dst: str, link: Link,
                symmetric: bool = True) -> "NetworkModel":
        self._links[(src, dst)] = link
        if symmetric:
            self._links[(dst, src)] = link
        return self

    def links(self) -> dict[tuple[str, str], Link]:
        """The explicitly-connected directed pairs (a copy).

        Introspection view for the plan linter: ``link()`` silently falls
        back to the default link for any pair not listed here, so a
        ``connect(symmetric=False)`` whose reverse direction a plan relies
        on can be flagged (SCN110) instead of mispriced invisibly.
        """
        return dict(self._links)

    def link(self, src: str, dst: str) -> Link:
        hit = self._links.get((src, dst))
        if hit is not None:
            return hit
        # an explicit (src, src) entry models a real same-box staging cost
        # (e.g. host <-> accelerator); only *implicit* self-links are free
        return LOOPBACK if src == dst else self._default

    def comm_time(self, src: str, dst: str, nbytes: float) -> float:
        return self.link(src, dst).comm_time(nbytes)


def paper_network(access: Link = FOUR_G,
                  device: str = "device",
                  edges: tuple[str, ...] = ("edge1", "edge2"),
                  clouds: tuple[str, ...] = ("cloud", "cloud_gpu")) -> NetworkModel:
    """The paper's testbed wiring: device -> edge over ``access`` (3G / 4G /
    wired, Figure 6-8's variable), edge -> cloud fixed at 25 ms / 50 Mbps,
    device -> cloud over the access link as well."""
    net = NetworkModel()
    for e in edges:
        net.connect(device, e, access)
        for c in clouds:
            net.connect(e, c, EDGE_CLOUD)
    for c in clouds:
        net.connect(device, c, access)
    return net


def tpu_network() -> NetworkModel:
    net = NetworkModel(default=DCN)
    net.connect("edge_v5e1", "regional_v5e16", DCN)
    net.connect("regional_v5e16", "pod_v5e256", DCN)
    net.connect("edge_v5e1", "pod_v5e256", DCN)
    return net
