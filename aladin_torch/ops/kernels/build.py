"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each source under ``aladin_torch/csrc/`` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries go to ``aladin_torch/_build/``, named by a hash of the
source and the flags, so an edited source never loads a stale library.
Nothing is built when a module is imported: the first launch builds, and
``build_all`` builds every source at once with one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC_DIR), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("mrsw_kernel.cu", "attention_kernel.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(put nvcc on PATH or set CUDA_HOME)")


def library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{os.path.splitext(source)[0]}-{digest}.so")


def _start(source: str, force: bool = False):
    """Start nvcc for ``source`` unless its library exists (or ``force``);
    returns (target, tmp, process) or None."""
    target = library_path(source)
    if os.path.exists(target) and not force:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(source: str, job) -> None:
    if job is None:
        return
    target, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing


def build_all(force: bool = False) -> Dict[str, float]:
    """Compile every source in parallel (``force``: even those already
    built); returns {"seconds": wall time}."""
    t0 = time.perf_counter()
    jobs = [(s, _start(s, force)) for s in SOURCES]
    for source, job in jobs:
        _finish(source, job)
    return {"seconds": time.perf_counter() - t0}


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """The built library of ``source``, building it on first use."""
    _finish(source, _start(source))
    return ctypes.CDLL(library_path(source))
