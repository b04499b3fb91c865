"""Build and bind the hand-written CUDA kernels.

Each source in ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``repro_torch/_build/<content hash>/``, and loaded with ctypes.
Pointers and the stream travel as ``c_void_p``; every launch function
returns ``cudaGetLastError()``, which ``check`` turns into an exception.

Flags: ``-O3 --fmad=false`` (no fused multiply-add: every float64 op
rounds as the reference's), no fast math, ``-Xptxas -v`` so the build
log carries each kernel's registers, stack frame and spills.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"

#: library name → (source, the C launch function and its argument types)
_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBS = {
    "tag_probe": ("tag_probe.cu", "tag_probe_launch",
                  [_VP, _VP, _VP, _VP, _VP, _VP, _I64, _INT, _VP]),
    "sim_step": ("sim_step.cu", "sim_step_launch", [_VP, _I64, _VP]),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}
#: name → {"seconds": build time, "log": nvcc/ptxas output}
build_info: Dict[str, Dict] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set NVCC or add it to PATH)")


def _so_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / LIBS[name][0], *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode() + f.read_bytes())
    return BUILD / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str):
    so = _so_path(name)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC),
           str(CSRC / LIBS[name][0]), "-o", str(tmp)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, time.monotonic()


def _finish(name: str, started) -> None:
    if started is None:
        build_info.setdefault(name, {"seconds": 0.0, "log": "(cached)"})
        return
    proc, tmp, so, t0 = started
    log, _ = proc.communicate()
    build_info[name] = {"seconds": time.monotonic() - t0, "log": log}
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
    os.replace(tmp, so)


def build(names: List[str]) -> None:
    """Compile the named libraries, one nvcc each, all started together."""
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])


def load(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_so_path(name)))
        fn = getattr(lib, LIBS[name][1])
        fn.argtypes = LIBS[name][2]
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
