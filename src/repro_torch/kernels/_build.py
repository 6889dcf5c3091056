"""Build and load the port's CUDA kernels (the counterpart of the JAX
package's `kernels/compat.py`, which only handled TPU compiler params).

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with `ctypes`.  The
library lands in ``build/repro_torch/`` under the repository root, named by
a hash of its source, every shared header (``csrc/*.cuh``) and the flags,
so a process builds each kernel at most once and a changed source or
header never loads a stale library.  `build_all` starts one ``nvcc`` per
source at the same time.  Nothing is built at import: the first CUDA call
of a wrapper triggers it.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("fc_gemv", "decode_attention", "paged_decode_attention",
           "ssd_scan")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the repro_torch kernels")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=KERNELS) -> float:
    """Compile every listed kernel that is not built yet, one ``nvcc`` per
    source, all started together; load them.  Returns the seconds spent."""
    t0 = time.perf_counter()
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        procs = []
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for n in todo:
            out = _lib_path(n)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        for n, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {n}.cu:\n{log.decode()}")
            os.replace(tmp, out)      # atomic: a racing process sees all or none
        for n in todo:
            _LIBS[n] = ctypes.CDLL(str(_lib_path(n)))
    return time.perf_counter() - t0


def loaded() -> frozenset:
    """The kernels built and loaded in this process so far (the
    sanitizer's build census reads it)."""
    return frozenset(_LIBS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name]
    return lib


def check(err: int, name: str) -> None:
    """Raise on the `cudaGetLastError()` a launch function returned."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad.  A kernel
    launched through ctypes has no backward: its output would silently
    leave the autograd graph.  The wrappers call this before their
    CPU/plain dispatch, so the plain path refuses exactly what the card
    would."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward; call it under torch.no_grad() or on "
            "tensors that do not require grad (training takes the plain "
            "path)")
