"""Build the package's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` compiles with `nvcc` into
`abip_tpu_torch/_build/<name>-<hash>.so`, where the hash covers the
source, every header of `csrc/` and the flags, and loads through
`ctypes` (a plain C interface, no PyTorch headers: the build takes
seconds).  `load_all` builds several sources at once, one `nvcc` each.
`load` is safe to call from several threads: a lock per source makes
the first caller build and load it while the others wait for that one
library.
Nothing is compiled or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor
import hashlib
import os
import shutil
import subprocess
import threading
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


def source_key(name: str, csrc: Path = CSRC) -> str:
    """The cache key of `csrc/<name>.cu`: a hash of the source, of every
    header in `csrc/` (a source may include any of them) and of the
    flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


_LOCKS: dict = {}                  # source name -> its build lock
_LOCKS_GUARD = threading.Lock()


def load(name: str) -> Library:
    """Build `csrc/<name>.cu` if its hashed library is missing, then load
    it; every later call, from any thread, returns the same `Library`.
    Raises on a failed build, with nvcc's output."""
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:                         # check, build and load: one thread
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> Library:
    src = CSRC / f"{name}.cu"
    so = BUILD_DIR / f"{name}-{source_key(name)}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # pid and thread: no two builds ever share a temporary file
        tmp = so.with_name(
            f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
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


def load_all(names) -> dict:
    """`load` each source, the builds running side by side (one `nvcc`
    process each); returns {name: Library}.  Raises on the first failed
    build after all have finished."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(load, name) for name in names}
    return {name: f.result() for name, f in futures.items()}
