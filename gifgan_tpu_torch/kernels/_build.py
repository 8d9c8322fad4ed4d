"""Build and load the hand-written CUDA kernels of gifgan_tpu_torch/csrc.

Each `csrc/<name>.cu` exposes a plain C function and is compiled by nvcc on
its own into `gifgan_tpu_torch/_build/lib<name>-<hash>.so` (a directory
.gitignore lists), then loaded with ctypes. The hash covers the source and
the flags, the kernel's own `EXTRA_FLAGS` included, so an edited source or a
changed flag builds afresh and a stale library is never loaded. Nothing is
built at import: the first `load` builds what it needs, and `build` compiles
several sources at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one kernel. haar_stages compares sums with thresholds and must
# round every multiply and add on its own, as its plain PyTorch version
# does: nvcc's default contracts a * b + c into one fused operation.
EXTRA_FLAGS = {"haar_stages": ("-fmad=false",)}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "gifgan_tpu_torch build on a machine with the "
                           "CUDA toolkit")
    return path


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def lib_path(name: str) -> str:
    with open(source(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all nvcc processes
    at once. Returns nvcc's output (ptxas registers and spills) for each
    kernel built now; raises with that output on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in names:
        path = lib_path(n)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[n] = (path, tmp, subprocess.Popen(
            [_nvcc(), *flags(n), "-o", tmp, source(n)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (path, tmp, proc) in procs.items():
        logs[n], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}:\n{logs[n]}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(lib_path(name))
        return _libs[name]
