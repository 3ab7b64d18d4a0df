"""Build and load the port's CUDA sources.

Each `csrc/<name>.cu` exports a plain C launch function and is compiled by
`nvcc` for sm_90a into `immesh_tpu_torch/_build/lib<name>.so` at first use,
then loaded with ctypes.  Nothing is built or loaded at import time: this
module only runs when a kernel is launched on a CUDA tensor (or when a
caller builds ahead of time, as chip_smoke.py does).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# no --use_fast_math and no multiply-add contraction: every kernel repeats
# its plain PyTorch version's rounding exactly
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build(names: Iterable[str], force: bool = False) -> Dict[str, str]:
    """Compile each csrc/<name>.cu whose library is missing or older than
    its source (every one with `force`), one nvcc process per source, all
    started together.  Returns {name: library path}; raises
    CalledProcessError if any compile fails."""
    names = list(names)
    procs = {}
    for name in names:
        src, lib = source_path(name), library_path(name)
        fresh = (os.path.exists(lib)
                 and os.path.getmtime(lib) >= os.path.getmtime(src))
        if force or not fresh:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            procs[name] = (subprocess.Popen(cmd), cmd, tmp)
    failed = None
    for name, (proc, cmd, tmp) in procs.items():
        if proc.wait() != 0:
            failed = failed or subprocess.CalledProcessError(proc.returncode,
                                                             cmd)
        else:
            os.replace(tmp, library_path(name))
    if failed is not None:
        raise failed
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
    return lib
