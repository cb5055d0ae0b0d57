"""Timing on the card: CUDA events for kernels, synchronized host walls.

PyTorch returns before the device finishes, so a host clock measures
the enqueue unless the timed region ends in `torch.cuda.synchronize()`.
The helpers refuse to run without a card: a number from the CPU is not
a device time.
"""
from __future__ import annotations

import statistics
import time

import torch


def _need_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA card")


def cuda_ms(fn, *, iters=5, warmup=1):
    """Median device milliseconds of `fn()` over `iters` calls, each
    bracketed by CUDA events on the current stream, after `warmup`
    untimed calls."""
    _need_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, *, iters=25, warmup=2, hold_cycles=200_000_000,
              between=None):
    """Median device milliseconds of one `fn()` over `iters` calls, for
    kernels short enough that issuing them costs the host about as much
    as running them costs the card: every call and its event pair is
    queued behind a device-side wait of `hold_cycles` clock cycles, so the
    card runs them back to back and no host gap is timed.  `between()`,
    where given, runs before each call outside its events (a cache
    flush, for a cold time)."""
    _need_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(hold_cycles)
    for start, end in events:
        if between is not None:
            between()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def wall_s(fn):
    """(seconds, result) of `fn()` on the host clock, from a synchronized
    start to a synchronized end."""
    _need_cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out
