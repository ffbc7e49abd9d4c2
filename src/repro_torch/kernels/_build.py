"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), and loaded with ``ctypes``.  Builds happen at first use,
never at import: the CPU-only test host has no ``nvcc``.  All sources are
compiled at once, one ``nvcc`` each, into
``<repo>/build/repro_torch_kernels/<hash>/``, where the hash covers the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``nvcc``'s ``-Xptxas -v`` report (registers, shared
memory, spills per kernel) is kept beside each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
SOURCES = ("flash_attention", "decode_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes understood by the C entry points (csrc/common.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
# source name -> (C entry point, its argtypes, its error-string function)
SIGNATURES = {
    "flash_attention": ("fa_forward",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                         _I, _I, _I, _I, ctypes.c_float, ctypes.c_longlong,
                         _P],
                        "fa_error_string"),
    "decode_attention": ("da_forward",
                         [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _P, _I, _I, _I, ctypes.c_float, _I,
                          ctypes.c_longlong, _P],
                         "da_error_string"),
    "ssd_scan": ("ssd_forward",
                 [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                  _P, _I, ctypes.c_longlong, _P],
                 "ssd_error_string"),
}
# further C functions of a source: name -> argtypes (all return int)
EXTRA_FUNCTIONS = {
    "decode_attention": {"da_occupancy": [_I, _I, _I, _I, _I,
                                          ctypes.c_longlong, _P]},
    "ssd_scan": {"ssd_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _P, _I, _P]},
}

_libs: dict[str, ctypes.CDLL] = {}


def _cuda_tool(tool: str) -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", tool), shutil.which(tool)):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{tool} not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source not yet built (one ``nvcc`` per source, all
    started together) and return the build directory."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    nvcc = _cuda_tool("nvcc")
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.{os.getpid()}.tmp"
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out / f"lib{name}.so")
        else:
            failed.append(f"{name} (exit {rc}):\n{build_log(name)[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu`` (the ``-Xptxas -v`` report)."""
    path = build_dir() / f"{name}.log"
    return path.read_text() if path.exists() else ""


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) of ``csrc/<name>.cu``, from its build log:
    ``registers`` per thread, bytes of ``spill_stores`` and
    ``spill_loads``, and bytes of static shared memory ``smem`` (0 where
    ptxas names none: the kernels' tiles are dynamic shared memory)."""
    return parse_ptxas(build_log(name))


def parse_ptxas(log: str) -> dict[str, dict[str, int]]:
    """:func:`ptxas_report` of one ``-Xptxas -v`` log."""
    report: dict[str, dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = report.setdefault(m.group(1), {})
        elif entry is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            entry["spill_stores"] = int(m.group(1))
            entry["spill_loads"] = int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(m.group(1)) if m else 0
    return report


def sass_opcodes(name: str) -> dict[str, Counter]:
    """Per kernel (mangled name) of the built ``lib<name>.so``, the number
    of its SASS instructions of each opcode (e.g. ``HMMA``), by the
    opcode's name before the first ``.`` (``cuobjdump -sass``)."""
    return parse_sass(_sass_listing(str(build_all() / f"lib{name}.so")))


@functools.lru_cache(maxsize=None)
def _sass_listing(lib: str) -> str:
    """``cuobjdump -sass`` of a built library, once per path: a build's
    directory is named by the hash of its sources and never rewritten."""
    return subprocess.run([_cuda_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout


def parse_sass(sass: str) -> dict[str, Counter]:
    """:func:`sass_opcodes` of one ``cuobjdump -sass`` listing."""
    counts: dict[str, Counter] = {}
    fn = None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m.group(1)
            counts[fn] = Counter()
        elif fn is not None and (m := re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                line)):
            counts[fn][m.group(1)] += 1
    return counts


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        fn_name, argtypes, err_name = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, err_name)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        for extra, types in EXTRA_FUNCTIONS.get(name, {}).items():
            getattr(lib, extra).argtypes = types
            getattr(lib, extra).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def check(name: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error (a launch the driver
    refused never runs, and a later synchronize would not report it)."""
    if code != 0:
        err = getattr(library(name), SIGNATURES[name][2])
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({err(code).decode()})")


_strides: dict[tuple, ctypes.Array] = {}


def strides(*tensors: torch.Tensor, dims: int = 3) -> ctypes.Array:
    """The first ``dims`` element strides of each tensor, flattened:
    (batch, sequence, head) of a (B, S, H, ...) tensor, (batch, head, 1) of
    a (B, H, hd) one; with ``dims=2`` (batch, head) of a (B, H, ...) one.
    The C entry points only read the array, so one is kept per distinct
    set of strides."""
    vals = tuple(t.stride(i) for t in tensors for i in range(dims))
    arr = _strides.get(vals)
    if arr is None:
        arr = _strides[vals] = (ctypes.c_longlong * len(vals))(*vals)
    return arr
