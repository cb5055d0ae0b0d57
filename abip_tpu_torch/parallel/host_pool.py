"""Thread-parallel suite driver (the reference's batch-runner role).

Port of `abip_tpu/parallel/host_pool.py`.  The reference's bench layer
runs suite instances as parallel processes
(`scripts/bench-lp/README.md:18-20`); in-process, a thread pool shares
one set of built kernels.  Each instance runs the whole batched solver
(`device_solve_lp`) at B=1 in its own pool thread.

On the card every worker thread issues on a CUDA stream of its own, so
the solves can overlap on the device; a worker waits only for its own
stream (a read such as `.item()` synchronizes its stream alone, while
`torch.cuda.synchronize()` would stall every worker).  The first
instance of each shape is solved serially first: it builds the kernels
and warms the allocator before the threads race.  A worker records its
spans (`utils.profiling`) where the calling thread does.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import follow, tracing
from .batched import DeviceSolveResult, device_solve_lp

__all__ = ["pool_map", "solve_lp_pool"]


def pool_map(fn, items, workers: int | None = None):
    """Apply `fn` over `items` with a thread pool; returns a list.

    Worker exceptions propagate to the caller.  workers=None uses the
    host core count; workers=1 degenerates to a serial map.
    """
    workers = workers or os.cpu_count() or 1
    if workers == 1:
        return [fn(it) for it in items]
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))


def solve_lp_pool(problems, *, workers: int | None = None, device=None,
                  **kw):
    """Solve a suite of standard-form LPs `(A, b, c)` concurrently on
    `device` (default: the CUDA card).

    Each instance runs `device_solve_lp` with options `kw` on its own
    (one lane) in its own pool thread.  Returns a list of one-instance
    `DeviceSolveResult`s in input order."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    problems = [tuple(t(x) for x in p) for p in problems]
    local = threading.local()
    traced = tracing()

    def solve(p):
        with follow(traced):
            return solve_one(p)

    def solve_one(p):
        if dev.type != "cuda":
            return device_solve_lp(*p, **kw)
        stream = getattr(local, "stream", None)
        if stream is None:
            stream = local.stream = torch.cuda.Stream(dev)
        # the inputs were written on the default stream
        stream.wait_stream(torch.cuda.default_stream(dev))
        with torch.cuda.stream(stream):
            r = device_solve_lp(*p, **kw)
        stream.synchronize()
        return r

    # warm one instance per distinct shape: builds the kernels, warms the
    # allocator
    seen = set()
    warm = {}
    for i, (A, _, _) in enumerate(problems):
        if A.shape not in seen:
            seen.add(A.shape)
            warm[i] = solve(problems[i])

    out = pool_map(solve, [p for i, p in enumerate(problems) if i not in warm],
                   workers)
    it = iter(out)
    return [warm[i] if i in warm else next(it) for i in range(len(problems))]
