"""Tree checkpointing: msgpack + zstd, atomic writes, async option,
step-indexed directory layout with automatic latest-resume: the port of
``repro/checkpoint/ckpt.py``, whose files it reads and writes.

Format: one ``.ckpt.zst`` file per save holding the msgpack map
    {"step": int, "meta": {...}, "leaves": [{"dtype", "shape", "data"}]}
with the leaves in the reference's pytree order (for the port's dict trees:
keys sorted, depth first), each as its numpy dtype string (``"<f4"``...),
shape and raw little-endian bytes; bfloat16 goes as ``"bfloat16"`` through
a uint16 view.  Writes go to ``<name>.tmp`` then ``os.replace``, so a crash
mid-write never corrupts the latest checkpoint.

The module carries its own encoder and decoder for the part of msgpack the
format uses (nil, bool, int, float, str, bin, array and map), byte for byte
what ``msgpack.packb(..., use_bin_type=True)`` writes, so it needs no
``msgpack``.  ``zstandard`` is optional: without it checkpoints are written
uncompressed (same layout), and ``restore`` raises on a compressed one.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Any

import numpy as np
import torch

from ..models.layers import tree_leaves, tree_map, tree_unflatten

try:
    import zstandard
except ImportError:          # optional dep: fall back to uncompressed
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _compress(raw: bytes) -> bytes:
    if zstandard is None:
        return raw
    return zstandard.ZstdCompressor(level=3).compress(raw)


def _decompress(data: bytes) -> bytes:
    if not data.startswith(_ZSTD_MAGIC):
        return data              # written without compression
    if zstandard is None:
        raise RuntimeError(
            "checkpoint is zstd-compressed but the 'zstandard' package is "
            "not installed (pip install -r requirements-dev.txt)")
    return zstandard.ZstdDecompressor().decompress(data)


# -- the msgpack subset --------------------------------------------------------

def _pack_len(out: list, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """A length header: the fix form where one exists, else the smallest
    of the 8/16/32-bit forms (``codes``; a 0 code is absent)."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(bytes([obj]))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif obj >= 0:
            for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                   (0xCE, ">I", 0xFFFFFFFF),
                                   (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
                if obj <= top:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    return
            raise ValueError(f"msgpack: int {obj} too large")
        else:
            for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                   (0xD2, ">i", -0x80000000),
                                   (0xD3, ">q", -0x8000000000000000)):
                if obj >= low:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    return
            raise ValueError(f"msgpack: int {obj} too small")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack, as ``msgpack.packb(obj, use_bin_type=True)``."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _unpack(buf: memoryview, pos: int) -> tuple[Any, int]:
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[code], pos
    if code in _FIXED:
        fmt = _FIXED[code]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif code in _LENGTHS:
        fmt, kind = _LENGTHS[code]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")
    if kind in ("str", "bin"):
        data = bytes(buf[pos:pos + n])
        if len(data) != n:
            raise ValueError("msgpack: truncated data")
        return (data.decode("utf-8") if kind == "str" else data), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


def unpackb(data: bytes) -> Any:
    """The object of msgpack ``data``, as ``msgpack.unpackb(data,
    raw=False)`` gives it (arrays as lists)."""
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"msgpack: {len(data) - pos} trailing bytes")
    return obj


# -- leaves ------------------------------------------------------------------

def _encode_leaf(x) -> dict:
    t = torch.as_tensor(x).detach()
    if t.dtype == torch.bfloat16:
        a = t.cpu().view(torch.int16).numpy().view(np.uint16)
        return {"dtype": "bfloat16", "shape": list(a.shape),
                "data": a.tobytes()}
    a = t.cpu().numpy()
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "data": a.tobytes()}


def _decode_leaf(d, device) -> torch.Tensor:
    if d["dtype"] == "bfloat16":
        a = np.frombuffer(d["data"], np.uint16).reshape(d["shape"])
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        a = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(
            d["shape"])
        t = torch.from_numpy(a.copy())
    return t.to(device)


def save(path: str, tree: Any, step: int = 0, meta: dict | None = None
         ) -> None:
    payload = {
        "step": step,
        "meta": meta or {},
        "leaves": [_encode_leaf(x) for x in tree_leaves(tree)],
    }
    comp = _compress(packb(payload))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(comp)
    os.replace(tmp, path)          # atomic


def restore(path: str, like: Any) -> tuple[Any, int, dict]:
    """``like`` supplies the tree; each leaf is restored as a tensor on the
    device of ``like``'s leaf (the CPU where that is no tensor)."""
    with open(path, "rb") as f:
        payload = unpackb(_decompress(f.read()))
    like_leaves = tree_leaves(like)
    if len(like_leaves) != len(payload["leaves"]):
        raise ValueError(f"{path}: {len(payload['leaves'])} leaves, the tree "
                         f"holds {len(like_leaves)}")
    leaves = [_decode_leaf(d, t.device if torch.is_tensor(t) else "cpu")
              for d, t in zip(payload["leaves"], like_leaves)]
    return tree_unflatten(like, leaves), payload["step"], payload["meta"]


# -- step-indexed manager -----------------------------------------------------

class CheckpointManager:
    """``dir/step_00000123.ckpt.zst`` layout with retention + async writes.

    ``save`` copies the tree to the host, then serialises it on a worker
    thread (at most one write in flight: a save waits for the previous
    one), so the train loop is not stalled by I/O.
    """

    def __init__(self, directory: str, keep: int = 3, async_writes: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_writes = async_writes
        self._pending: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.ckpt.zst")

    def steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("step_") and f.endswith(".ckpt.zst"):
                out.append(int(f[5:13]))
        return sorted(out)

    def wait(self) -> None:
        """Wait for the write in flight; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(self, step: int, tree: Any, meta: dict | None = None) -> None:
        self.wait()
        # a copy on the host: the caller goes on updating its tensors in
        # place while the writer runs
        host_tree = tree_map(
            lambda t: t.detach().to("cpu", copy=True)
            if torch.is_tensor(t) else t, tree)

        def work():
            save(self._path(step), host_tree, step, meta)
            self._gc()

        def in_thread():
            try:
                work()
            except Exception as e:      # handed to the caller by wait()
                self._error = e

        if self.async_writes:
            self._pending = threading.Thread(target=in_thread, daemon=True)
            self._pending.start()
        else:
            work()

    def restore_latest(self, like: Any) -> tuple[Any, int, dict] | None:
        steps = self.steps()
        if not steps:
            return None
        return restore(self._path(steps[-1]), like)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            try:
                os.remove(self._path(s))
            except OSError:
                pass
