"""Build and bind the port's CUDA C++ kernels (``kubeflow_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc`` for ``sm_90a`` into ``csrc/build/lib<name>-<hash>.so`` at first use
(the build directory is git-ignored); the sources share the headers in
``csrc/*.cuh`` (``sm90.cuh``: TMA, mbarriers, wgmma). The library is
loaded with ``ctypes``; pointers and the CUDA stream cross as
``c_void_p``. Nothing here runs when the module is imported: building needs
``nvcc`` and a card, which only the machine that runs the kernels has.

``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them — the way a cold process (``chip_smoke.py``) pays the compile once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Every CUDA source of the port, by stem.
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "fused_xent")

_lock = threading.Lock()
_libs: dict[tuple[str, ...], ctypes.CDLL] = {}
#: ptxas resource report (registers, shared memory, spills) per source,
#: from the build that produced the loaded library.
PTXAS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled on the machine "
        "that runs them (CUDA toolkit with nvcc on PATH or /usr/local/cuda)")


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The library path of ``csrc/<name>.cu``: its tag hashes the source,
    every header under ``csrc/`` (a source may include any of them) and the
    flags with any ``defines``, so an edit to any of them builds a new
    library."""
    tag = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        tag.update(header.name.encode() + b"\0" + header.read_bytes())
    tag.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{tag.hexdigest()[:12]}.so"


def _start(name: str, defines: tuple[str, ...] = ()
           ) -> Optional[tuple[subprocess.Popen, Path, Path]]:
    """Launch nvcc for ``name`` unless its library is already built."""
    out = _target(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    PTXAS[name] = log
    os.replace(tmp, out)           # atomic: a reader never sees half a library


def build_all() -> dict[str, Path]:
    """Compile every source not yet built, all ``nvcc`` processes at once;
    returns each source's library path."""
    with _lock:
        jobs = {n: _start(n) for n in SOURCES}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    return {n: _target(n) for n in SOURCES}


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it on first use.
    ``defines`` (``NAME=VALUE``, passed as ``-D``) build a variant in a
    library of its own; the port's wrappers load none."""
    key = (name, *defines)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            job = _start(name, defines)
            if job is not None:
                _finish(" ".join(key), job)
            lib = ctypes.CDLL(str(_target(name, defines)))
            _libs[key] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point (a
    refused launch never runs, and a later synchronize would not say so)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def check_tma_aligned(name: str, tensors: dict, names) -> None:
    """A TMA tensor map's global address must be 16-byte aligned: raise,
    naming the tensor, for any of ``tensors[n]`` (n in ``names``) that
    does not start on a 16-byte boundary."""
    for n in names:
        off = tensors[n].data_ptr() % 16
        if off:
            raise ValueError(f"{name}: {n} starts {off} bytes past a "
                             "16-byte boundary; the kernel's TMA loads "
                             "need 16-byte aligned tensors")
