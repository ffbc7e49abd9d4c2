"""Production and smoke meshes: the port of ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group.

The production meshes stand in for the reference's emulated host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=512``): one process
joins a 512-rank *fake* process group
(``torch.testing._internal.distributed.fake_pg``), whose collectives
return at once and move nothing, and both meshes are built over its ranks.
Tensors on such a mesh live on ``meta``: the dry-run traces shapes,
placements and collectives, and no device is touched.
"""

from __future__ import annotations

import os

import torch

PRODUCTION_RANKS = 512


def _fake_world():
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake" or \
                dist.get_world_size() != PRODUCTION_RANKS:
            raise RuntimeError(
                f"the production mesh needs a {PRODUCTION_RANKS}-rank fake "
                f"process group; this process already joined a "
                f"{dist.get_world_size()}-rank {dist.get_backend()!r} group")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=PRODUCTION_RANKS)


_MESHES: dict = {}


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod (ranks 0-255 of the group); 2 pods = 512
    ranks with a leading 'pod' axis for cross-pod data parallelism.  Each
    is built once a process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    _fake_world()
    if _MESHES.get("world") is not dist.group.WORLD:   # a group made anew
        _MESHES.clear()
        _MESHES["world"] = dist.group.WORLD
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = init_device_mesh(
            "cpu", (2, 16, 16), mesh_dim_names=("pod", "data", "model")) \
            if multi_pod else DeviceMesh(
                "cpu", torch.arange(256).reshape(16, 16),
                mesh_dim_names=("data", "model"))
    return _MESHES[multi_pod]


def make_smoke_mesh(device: str | torch.device = "cuda"):
    """A 1 x 1 ``data x model`` mesh over a one-rank group on ``device``:
    NCCL on the card, gloo on the CPU.  The group is made here when the
    process has none (its address is ``localhost`` on a free port)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device)
    if not dist.is_initialized():
        os.environ.setdefault("MASTER_ADDR", "localhost")
        os.environ.setdefault("MASTER_PORT", str(_free_port()))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=0, world_size=1)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
