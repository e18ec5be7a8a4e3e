"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and builds on
first use into its own shared library (``library``; ``build`` compiles
several sources concurrently) under ``build/dvsg_tpu_torch/`` at
the root of the checkout, named by a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. A failed
build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "dvsg_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built on the machine with the "
                       "card")


def _target(name: str) -> tuple[str, str]:
    """(source path, hash-named library path) of ``csrc/<name>.cu``."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"{name}-{digest.hexdigest()[:12]}.so")


def build(names) -> dict[str, float]:
    """Build and load the libraries of several sources, one nvcc process
    per source, all started together. Returns each source's build seconds
    (0.0 for one that was already built)."""
    t0 = time.perf_counter()
    running, seconds, paths = [], {}, {}
    for name in dict.fromkeys(names):
        src, path = paths[name] = _target(name)
        seconds[name] = 0.0
        if name in _libs or os.path.exists(path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, proc, tmp, path))
    errors = []
    for name, proc, tmp, path in running:
        _, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on csrc/{name}.cu (exit "
                          f"{proc.returncode}):\n{err}")
        else:
            os.replace(tmp, path)          # atomic: no half-written .so
    if errors:
        raise RuntimeError("\n".join(errors))
    for name, (_, path) in paths.items():
        if name not in _libs:
            _libs[name] = ctypes.CDLL(path)
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build([name])
    return _libs[name]
