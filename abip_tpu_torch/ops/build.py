"""Build the package's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` compiles with `nvcc` into
`abip_tpu_torch/_build/<name>-<hash>.so`, where the hash covers the
source and the flags, and loads through `ctypes` (a plain C interface,
no PyTorch headers: the build takes seconds).  Nothing is compiled or
imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Hopper only (sm_90a).  No -use_fast_math: the kernels rely on IEEE
# sqrtf and division.  -Xptxas -v records registers and spills in the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Library(NamedTuple):
    lib: ctypes.CDLL
    build_seconds: float   # 0.0 when the library was already built
    log: str               # nvcc's output of this build, "" when cached


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of abip_tpu_torch are built from source at first use")


@functools.lru_cache(maxsize=None)
def load(name: str) -> Library:
    """Build `csrc/<name>.cu` if its hashed library is missing, then load
    it.  Raises on a failed build, with nvcc's output."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
        os.replace(tmp, so)   # atomic: a concurrent build never sees half a file
    return Library(ctypes.CDLL(str(so)), seconds, log)
