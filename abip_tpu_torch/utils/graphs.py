"""CUDA graphs of a block of masked iterations, replayed with one host read.

A loop that would read its stop test on the host every iteration runs
instead as blocks: a body that reads and writes only static buffers and
writes a small int64 flag (whether the loop goes on, and its counts),
which the host reads once a block.  The loop keeps its body, its key and
its state; this module keeps the static operands, the capture and
replay, the launch counts of a replay and the process's graphs.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import weakref

import torch

from .profiling import host_read

_CAPTURE_LOCK = threading.Lock()        # one capture at a time


# per thread, `.counts`: {kernel wrapper: launches} of the block it captures
_tally = threading.local()


def count_launch(kernel):
    """Count one launch of `kernel`, a function with a `launches`
    counter.  A launch recorded into a capture runs only at the graph's
    replays: it goes to the capturing thread's tally, and each replay of
    the `BlockGraph` adds it to the counter."""
    counts = getattr(_tally, "counts", None)
    if not torch.cuda.is_current_stream_capturing():
        kernel.launches += 1
    elif counts is not None:
        counts[kernel] = counts.get(kernel, 0) + 1


class BlockGraph:
    """A block whose `body()`, defined by a subclass, reads the static
    copies `static` ({name: tensor}) of its named operands and writes
    only into static buffers and the int64 `flag`.  On a CUDA card it is
    captured as a CUDA graph at its first run and replayed at the later
    ones; elsewhere it runs uncaptured each time.  `lock` is held by the
    caller that uses it (`GraphCache.take`)."""

    captures = 0            # graphs captured by this process

    def __init__(self, flag: torch.Tensor, operands):
        self.flag = flag
        self.static = {name: torch.empty_like(t) for name, t in operands}
        self._loaded = {}
        self.graph = None
        self.replayed = {}  # {kernel wrapper: launches} of one replay
        self.lock = threading.Lock()

    def load_operands(self, operands):
        """Copy in each (name, tensor) that is not the one loaded last."""
        for name, t in operands:
            ref = self._loaded.get(name)
            if ref is None or ref() is not t:
                self.static[name].copy_(t)
                self._loaded[name] = weakref.ref(t)

    def run(self) -> list:
        """One block on the loaded state, then its one blocking read:
        the flag's values."""
        if self.graph is not None:
            self.graph.replay()
            for kernel, n in self.replayed.items():
                kernel.launches += n
        elif self.flag.is_cuda:
            self._capture()
        else:
            self.body()
        with host_read():
            return self.flag.tolist()

    def _capture(self):
        """Run the block once uncaptured on a side stream (the libraries
        set up their handles and workspaces there), then capture it on
        that stream.  Not through `torch.cuda.graph`, which first
        synchronizes the card, collects garbage and empties the
        allocator's cache: the capture needs none of them."""
        side = torch.cuda.Stream(self.flag.device)
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.body()
            with _CAPTURE_LOCK:
                _tally.counts = {}
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.body()
                finally:
                    graph.capture_end()
                BlockGraph.captures += 1
        torch.cuda.current_stream().wait_stream(side)
        self.replayed, _tally.counts = _tally.counts, None
        self.graph = graph


class GraphCache:
    """At most `kept` graphs by key, least recent out."""

    def __init__(self, kept: int):
        self.kept = kept
        self._graphs = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._graphs)

    @contextlib.contextmanager
    def take(self, key, make):
        """The graph of `key` (`make()` where there is none) with its
        lock held inside the context, or None where another thread holds
        it, so that the caller runs its eager loop."""
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None:
                graph = self._graphs[key] = make()
                while len(self._graphs) > self.kept:
                    self._graphs.popitem(last=False)
            self._graphs.move_to_end(key)
            if not graph.lock.acquire(blocking=False):
                graph = None
        try:
            yield graph
        finally:
            if graph is not None:
                graph.lock.release()
