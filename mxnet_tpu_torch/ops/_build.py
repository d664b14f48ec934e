"""Build and bind the port's CUDA kernels.

Every ``ops/csrc/*.cu`` source is compiled at first use, on the machine
with the card, by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into a shared library of its own with a plain C
interface, and bound with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  All sources compile at once, one ``nvcc`` process each.  The
libraries land in ``build/torch_kernels/`` at the repository root, named
by a hash of their source, so an edited source rebuilds and an unchanged
one loads from disk.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

from ..base import MXNetError

__all__ = ["CSRC_DIR", "BUILD_DIR", "build_all", "kernel_function",
           "check_launch"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "torch_kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel source: {"seconds": build wall time or 0.0 when loaded from
#: disk, "ptxas": the compiler's register/shared-memory report}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise MXNetError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA "
            f"kernels need the CUDA toolkit")
    return found


def _sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}.{digest}.so")


def _build_locked() -> None:
    todo = {n: _lib_path(n) for n in _sources() if n not in _libs}
    pending = {n: p for n, p in todo.items() if not os.path.exists(p)}
    procs = {}
    if pending:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        for name, path in pending.items():
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, name + ".cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failures = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, path)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "ptxas": out.strip()}
        if failures:
            raise MXNetError("CUDA kernel build failed: "
                             + "\n".join(failures))
    for name, path in todo.items():
        build_info.setdefault(name, {"seconds": 0.0, "ptxas": ""})
        _libs[name] = ctypes.CDLL(path)


def build_all() -> Dict[str, dict]:
    """Compile (in parallel) and load every kernel source not loaded yet;
    returns :data:`build_info`."""
    with _lock:
        _build_locked()
    return build_info


def kernel_function(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` (built and loaded on
    first use) with its ``argtypes`` declared and an ``int``
    (cudaError_t) result."""
    if name not in _libs:
        build_all()
        if name not in _libs:
            raise MXNetError(f"no CUDA kernel source named {name!r}")
    fn = getattr(_libs[name], symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check_launch(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise MXNetError(f"{what}: CUDA kernel launch failed with "
                         f"cudaError_t {rc}")
