"""Build and load the port's hand-written CUDA kernels.

Each source under ``crdt_tpu_torch/csrc/`` exposes a plain C interface
and is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared
library, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds. Builds happen at first use, into ``crdt_tpu_torch/csrc/build/``
(listed in ``.gitignore``), keyed by a hash of the source and the flags
so an edited source is rebuilt. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# One lock per source: a source builds once, two sources may build at once.
_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# source name -> {"seconds": build time (0.0 when cached), "log": nvcc output}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "crdt_tpu_torch cannot be built on this machine"
    )


def _target(source: str) -> str:
    """The shared library path of ``csrc/<source>`` for the current
    source text and flags."""
    with open(os.path.join(_CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{os.path.splitext(source)[0]}-{digest}.so")


def library(source: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<source>``, built on first use.
    Raises RuntimeError when it cannot be built."""
    with _locks.setdefault(source, threading.Lock()):
        if source not in _libs:
            out = _target(source)
            info = {"seconds": 0.0, "log": ""}
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, source)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                info = {"seconds": time.perf_counter() - t0, "log": proc.stdout.strip()}
                if proc.returncode != 0:
                    build_info[source] = info
                    raise RuntimeError(f"nvcc failed on {source}:\n{info['log']}")
                os.replace(tmp, out)
            build_info[source] = info
            _libs[source] = ctypes.CDLL(out)
        return _libs[source]
