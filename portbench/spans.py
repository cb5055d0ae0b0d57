"""What the span metrics share: the program's span trees of a `--trace 1`
run's profiled calls (`abip_tpu_torch.utils.profiling.spans()`).

A tree is the list of the spans under one root, oldest first, the root
first.  A program that records no spans, or a record that does not hold
the profiled calls, gives None, and the metric is left out.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


def trees(record, layer):
    """The trees of the newest P roots named `<layer>.solve`, P the
    number of profiled calls, in the calls' order; None where fewer are
    recorded, or where a root's noted ADMM counts are not its call's
    answers."""
    prof = record.profile
    if prof is None or not prof.calls:
        return None
    try:
        from abip_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    by_request = defaultdict(list)
    for s in spans():
        by_request[s.request_id].append(s)
    roots = [t for t in by_request.values()
             if t[0].parent_id is None and t[0].name == f"{layer}.solve"]
    calls = len(prof.calls)
    if len(roots) < calls:
        return None
    roots = roots[-calls:]
    for tree, (_, answers) in zip(roots, prof.calls):
        noted = tree[0].attrs.get("admm_iters")
        if noted is None:
            return None
        if not np.array_equal(_numpy(noted).reshape(-1),
                              np.asarray(answers["admm_iters"]).reshape(-1)):
            return None
    return roots


def _numpy(value):
    return np.asarray(value.cpu() if hasattr(value, "cpu") else value)


def admm_iters(trees):
    """The ADMM iterations noted on the trees' roots, summed."""
    return int(sum(_numpy(t[0].attrs["admm_iters"]).sum() for t in trees))


def named(tree, name):
    """The spans of `tree` called `name`."""
    return [s for s in tree if s.name == name]


def seconds(spans):
    """The summed durations of `spans`."""
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-9


def share(layer, record):
    """Percent of the profiled calls' root spans spent in the layer's
    blocking reads (`<layer>.host_read`)."""
    ts = trees(record, layer)
    if ts is None:
        return None
    reads = seconds(s for t in ts for s in named(t, f"{layer}.host_read"))
    return 100.0 * reads / seconds(t[0] for t in ts)
