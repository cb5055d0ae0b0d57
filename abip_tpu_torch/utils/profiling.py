"""Tracing: named spans in the solver's layers, and a trace of a solve.

`annotate(name)` is the port's one span.  While no `torch.profiler`
session records the calling thread it returns one shared no-op context
manager, so a span costs one flag test.  While a session records, it
opens a `torch.profiler.record_function` range of the name, which the
session's trace shows beside the card's work, and records the span in
memory: `spans()` returns the record, `clear()` empties it.

A span's parent is the innermost span open on its thread, and every
span under one root shares the root's span id as its request id.  Times
are `time.time_ns()`, the host clock the profiler stamps its events
with, so spans line up with the session's device trace.  The record
keeps the spans of the newest `KEEP_ROOTS` root spans.

A session records only the thread that started it; a pool worker runs
inside `follow(tracing())`, taken on the submitting thread, to record
its spans all the same.

Port of `abip_tpu/utils/profiling.py`, whose `annotate` is a bare named
range.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque

import torch

KEEP_ROOTS = 64

_profiler_enabled = torch.autograd._profiler_enabled
_ids = itertools.count(1)


class _ThreadSpans(threading.local):
    """Per thread: the open spans, innermost last, and whether the
    thread follows a recording caller."""

    follows = False

    def __init__(self):
        self.open = []


_thread = _ThreadSpans()


class _Record:
    """The span trees of the newest `keep` roots, oldest root first."""

    def __init__(self, keep):
        self.trees = deque(maxlen=keep)
        self.lock = threading.Lock()

    def add_root(self, span):
        tree = [span]
        with self.lock:
            self.trees.append(tree)
        return tree

    def spans(self):
        with self.lock:
            trees = list(self.trees)
        out = [s for tree in trees for s in list(tree) if s.end_ns is not None]
        out.sort(key=lambda s: (s.start_ns, s.span_id))
        return out

    def clear(self):
        with self.lock:
            self.trees.clear()


_record = _Record(KEEP_ROOTS)


class Span:
    """One span: `name`, `span_id`, `parent_id` (None for a root),
    `request_id` (its root's span id), `thread` (`threading.get_ident`),
    `start_ns`, `end_ns` (None while open) and `attrs`, what the code
    under it noted (`note`)."""

    __slots__ = ("name", "span_id", "parent_id", "request_id", "thread",
                 "start_ns", "end_ns", "attrs", "_tree", "_range")

    def __init__(self, name):
        self.name = name
        self.end_ns = None
        self.attrs = {}

    def note(self, **attrs):
        """Attach values to the span (a root's result counts)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _thread.open
        self.span_id = next(_ids)
        self.thread = threading.get_ident()
        self.start_ns = time.time_ns()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if stack:
            parent = stack[-1]
            self.parent_id, self.request_id = parent.span_id, parent.request_id
            self._tree = parent._tree
            self._tree.append(self)
        else:
            self.parent_id, self.request_id = None, self.span_id
            self._tree = _record.add_root(self)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _thread.open.pop()
        self._range.__exit__(*exc)
        self._range = None
        self.end_ns = time.time_ns()
        return False


class _Off:
    """The span while nothing records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs):
        pass


_OFF = _Off()


def tracing() -> bool:
    """Whether spans opened on this thread are recorded."""
    return _profiler_enabled() or _thread.follows


def annotate(name: str):
    """The span `name` as a context manager (`_OFF` while nothing
    records); `with annotate(...) as span` gives it for `span.note`."""
    if not (_profiler_enabled() or _thread.follows):
        return _OFF
    return Span(name)


def host_read():
    """The span of a blocking read of the device's values on the host,
    `<layer>.host_read`, where `<layer>` is the first word of the
    innermost open span's name (`lp.admm` -> `lp.host_read`)."""
    if not (_profiler_enabled() or _thread.follows):
        return _OFF
    stack = _thread.open
    layer = stack[-1].name.partition(".")[0] + "." if stack else ""
    return Span(layer + "host_read")


@contextlib.contextmanager
def follow(on: bool):
    """Record this thread's spans inside the context where `on`: a pool
    worker passes `tracing()` of the thread that submitted its work."""
    before = _thread.follows
    _thread.follows = on
    try:
        yield
    finally:
        _thread.follows = before


def spans():
    """The recorded spans that have closed, oldest first."""
    return _record.spans()


def clear():
    """Forget every recorded span."""
    _record.clear()


@contextlib.contextmanager
def trace_solve(log_dir: str):
    """Trace the host and, where there is one, the CUDA card inside the
    context; writes `<log_dir>/trace.json` (Chrome trace format) and
    yields the profiler, whose `key_averages()` sums time by op.  The
    spans of the solves inside are recorded too (`spans()`).

    Usage::
        with trace_solve("trace-dir"):
            abip_tpu_torch.solve_lp(A, b, c)
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
