"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers,
so ``nvcc`` builds it in seconds (route (b) of the Hopper kernel notes:
a source that includes PyTorch's headers takes minutes).  Every source
is compiled by its own ``nvcc`` process, all started together, into
``build/<hash>/lib<name>.so``, where the hash covers every source and
the compiler flags: an edited source or flag set builds anew, an
unchanged one is loaded from disk.  The build runs at first use, never
at import, so the package imports on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"  # in .gitignore
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": wall time of its nvcc, "log": nvcc's stderr
# (ptxas register/shared-memory report)}; empty when loaded from disk.
build_info: Dict[str, Dict[str, object]] = {}


def _sources() -> List[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC}")
    return srcs


def _build_dir(srcs: List[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the fused kernels are built from "
        f"{CSRC} at first use and need the CUDA toolkit")


def _build_all(srcs: List[Path], out_dir: Path) -> None:
    """One nvcc per source, all in flight at once; raises with the
    compiler's output if any fails."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in srcs:
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out_dir / f"lib{src.stem}.so")  # atomic publish
        build_info[src.stem] = {"seconds": time.perf_counter() - t0,
                                "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``; builds every
    source on the first call of the process."""
    with _lock:
        if name not in _libs:
            srcs = _sources()
            out_dir = _build_dir(srcs)
            if not all((out_dir / f"lib{s.stem}.so").exists() for s in srcs):
                _build_all(srcs, out_dir)
            for s in srcs:
                _libs[s.stem] = ctypes.CDLL(str(out_dir / f"lib{s.stem}.so"))
        if name not in _libs:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        return _libs[name]


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``lib<name>.so`` with its argument types declared
    (``c_void_p`` for every pointer and the stream: left undeclared,
    ctypes would pass a Python int as a 32-bit int and cut it)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point
    of ``lib`` (a refused launch never runs, and a later synchronize
    would not report it)."""
    if status != 0:
        fn = lib.dsod_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {status} at launch "
            f"({fn(status).decode(errors='replace')})")
