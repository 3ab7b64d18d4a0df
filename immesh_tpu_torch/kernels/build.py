"""Build and load the port's native sources.

Each `csrc/<name>.cu` exports a plain C launch function and is compiled by
`nvcc` for sm_90a; each `csrc/<name>.cpp` is a host library compiled by the
machine's C++ compiler.  Either lands in `immesh_tpu_torch/_build/
lib<name>.so` at first use and is loaded with ctypes.  Nothing is built or
loaded at import time: this module only runs when a kernel is launched on a
CUDA tensor, when the host frontend first decodes a buffer, or when a caller
builds ahead of time, as chip_smoke.py does.  A failed build raises with the
compiler's output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# no --use_fast_math and no multiply-add contraction: every kernel repeats
# its plain PyTorch version's rounding exactly
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
# host libraries: no -march=native (the library must run on any x86-64 the
# checkout lands on) and no FMA contraction (the decode gates round as
# their NumPy oracle does)
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    cu = os.path.join(CSRC_DIR, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC_DIR, f"{name}.cpp")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _command(src: str, out: str) -> List[str]:
    if src.endswith(".cu"):
        return [_nvcc(), *NVCC_FLAGS, "-o", out, src]
    return [os.environ.get("CXX") or "c++", *CXX_FLAGS, "-o", out, src]


def build(names: Iterable[str], force: bool = False) -> Dict[str, str]:
    """Compile each csrc/<name>.{cu,cpp} whose library is missing or older
    than its source (every one with `force`), one compiler process per
    source, all started together.  Each writes a private temporary file
    that is renamed into place, so concurrent builds (test workers) never
    load a half-written library.  Returns {name: library path}; raises
    RuntimeError with the compiler's output if any compile fails."""
    names = list(names)
    procs = {}
    for name in names:
        src, lib = source_path(name), library_path(name)
        fresh = (os.path.exists(lib)
                 and os.path.getmtime(lib) >= os.path.getmtime(src))
        if force or not fresh:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = _command(src, tmp)
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), cmd, tmp)
    failed = []
    for name, (proc, cmd, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("building the port's native sources failed:\n"
                           + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
    return lib


# each counted kernel module's reader of its launches recorded under stream
# capture, {kernel: count} (register_captured)
_CAPTURED: List[Callable[[], Dict[str, int]]] = []


def register_captured(read: Callable[[], Dict[str, int]]) -> None:
    """Register a kernel module's reader of the launches its wrappers
    recorded under stream capture, by kernel (its `captured`)."""
    _CAPTURED.append(read)


def captured_launches() -> Dict[str, int]:
    """The launches recorded under stream capture, by kernel, of every
    kernel module imported so far (a kernel not imported launched none)."""
    return {k: n for read in _CAPTURED for k, n in read().items()}


def bind_runs(lib: ctypes.CDLL, prefix: str) -> None:
    """Declare a kernel library's device run counters: `<prefix>_runs(out)`
    copies them to the host, `<prefix>_reset_runs()` zeroes them, each on
    the current device, each returning the CUDA error."""
    getattr(lib, f"{prefix}_runs").argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong)]
    getattr(lib, f"{prefix}_runs").restype = ctypes.c_int
    getattr(lib, f"{prefix}_reset_runs").argtypes = []
    getattr(lib, f"{prefix}_reset_runs").restype = ctypes.c_int


def read_runs(lib: ctypes.CDLL, prefix: str, n: int,
              devices: Iterable[int]) -> List[int]:
    """A library's n device run counters (bind_runs), summed over the CUDA
    `devices`, each synchronised first: the kernels' runs on the device,
    eager or replayed in a CUDA graph."""
    import torch
    total = [0] * n
    for d in sorted(devices):
        with torch.cuda.device(d):
            torch.cuda.synchronize()
            out = (ctypes.c_ulonglong * n)()
            err = getattr(lib, f"{prefix}_runs")(out)
            if err != 0:
                raise RuntimeError(f"{prefix}: reading the run counters "
                                   f"failed: CUDA error {err}")
            total = [t + v for t, v in zip(total, out)]
    return total


def reset_runs(lib: ctypes.CDLL, prefix: str, devices: Iterable[int]) -> None:
    """A library's device run counters to 0 on the CUDA `devices`, each
    synchronised first."""
    import torch
    for d in sorted(devices):
        with torch.cuda.device(d):
            torch.cuda.synchronize()
            err = getattr(lib, f"{prefix}_reset_runs")()
            if err != 0:
                raise RuntimeError(f"{prefix}: resetting the run counters "
                                   f"failed: CUDA error {err}")
