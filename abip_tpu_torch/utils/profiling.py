"""Profiling hooks: named ranges and a device trace, on `torch.profiler`.

Port of `abip_tpu/utils/profiling.py`: named ranges around the solver
phases and a trace of everything inside a context, viewable in Perfetto
or `chrome://tracing`.
"""
from __future__ import annotations

import contextlib
import os


def annotate(name: str):
    """Named range, usable as decorator or context manager."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace_solve(log_dir: str):
    """Trace the host and, where there is one, the CUDA card inside the
    context; writes `<log_dir>/trace.json` (Chrome trace format) and
    yields the profiler, whose `key_averages()` sums time by op.

    Usage::
        with trace_solve("trace-dir"):
            abip_tpu_torch.solve_lp(A, b, c)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
