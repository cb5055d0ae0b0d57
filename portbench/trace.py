"""The traced stretch of a `--trace 1` run: a few more calls of the cell
under `torch.profiler`, read into device time by kernel, the device's
busy time within the calls and the breakdown the result line carries.

The host and the card are both recorded (the host for the benchmark's
spans, `portbench.generate`, `portbench.solve` and `portbench.answers`,
and for naming what the host did while the card was idle), so host
loops run slower under the profiler than without it: the shares read
here are of the profiled calls.
"""
from __future__ import annotations

import bisect
import gc
from collections import defaultdict
from types import SimpleNamespace

TOP = 10
SCAN = 100_000


# the profiler's own host events, which name no work of the run
PROFILER_EVENTS = ("Activity Buffer Request",)


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every recorded event but
    the device's copies of named ranges (a range is no device work)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device and (e.is_user_annotation()
                          or e.name().startswith("portbench.")):
            continue
        start = e.start_ns()
        out.append((e.name(), on_device, start, start + e.duration_ns()))
    return out


def _merge(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_busy(fn):
    """(fn(), the seconds in which an operation ran on the card while fn
    ran, with the count of device operations): the union of the device's
    intervals, recorded by `torch.profiler` with the card's activity
    alone, so the host loop pays no record of its own operations."""
    import torch
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    cuda = torch.autograd.DeviceType.CUDA
    gc.disable()     # millions of events: spare the collector's passes
    try:
        spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda and not e.is_user_annotation()
                 and not e.name().startswith("portbench.")]
        busy = sum(e - s for s, e in _merge(spans))
    finally:
        gc.enable()
    return out, busy * 1e-9, len(spans)


def profile(solver, seed, start, count):
    """Profile the window's calls `start` .. `start + count - 1` of
    `solver`."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    calls = []
    with torch.profiler.profile(activities=acts) as prof:
        for k in range(start, start + count):
            calls.append(solver.run(solver.keys(seed, k)))
    events = _events(prof)
    spans = sorted((s, e) for name, dev, s, e in events
                   if not dev and name == "portbench.solve")
    host = sorted((s, e, name) for name, dev, s, e in events
                  if not dev and not name.startswith("portbench.")
                  and name not in PROFILER_EVENTS)
    kernel_s, launches, busy, gaps = (defaultdict(float), defaultdict(int),
                                      0, [])
    device = [(s, e, name) for name, dev, s, e in events if dev]
    for lo, hi in spans:
        inside = [(max(s, lo), min(e, hi), name) for s, e, name in device
                  if e > lo and s < hi]
        for s, e, name in inside:
            kernel_s[name] += (e - s) * 1e-9
            launches[name] += 1
        merged = _merge((s, e) for s, e, _ in inside)
        busy += sum(e - s for s, e in merged)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps += [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
    starts = [h[0] for h in host]

    def doing(t):
        """The innermost host event running at time t, among the
        `SCAN` that started last before it."""
        hi = bisect.bisect_right(starts, t)
        for i in range(hi - 1, max(hi - SCAN, 0) - 1, -1):
            if host[i][1] >= t:
                return host[i][2]
        return "between host events"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    window_ns = sum(e - s for s, e in spans)
    return SimpleNamespace(
        calls=calls, window_s=window_ns * 1e-9, busy_s=busy * 1e-9,
        kernel_s=dict(kernel_s), launches=dict(launches),
        breakdown={
            "device_ops": [[name[:120], sec] for name, sec in sorted(
                kernel_s.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[doing((s + e) // 2)[:120], (e - s) * 1e-9]
                          for s, e in longest]})
