"""What the metric files read from a run's record.

A record has `setup_s`, `walls` and `answers` (one per timed call: the
numpy `status`, `admm_iters`, `x`, `y`, `s` of its instances),
`window_busy_s` (the card's busy seconds over the window, where a
`--trace 0` run recorded them, else None) and, in a `--trace 1` run,
`profile` (`trace.profile`'s result).  A reader that
finds nothing to read returns None, and the run leaves its metric out.
"""
from __future__ import annotations

import numpy as np

from portbench import roofline


def _solved(record):
    return sum(int((a["status"] == 1).sum()) for a in record.answers)


def _admm(answers):
    return float(sum(a["admm_iters"].sum() for a in answers))


def instances_per_s(record):
    """Solved instances over the window; an unsolved one counts in no
    rate."""
    return _solved(record) / sum(record.walls)


def instances_per_device_s(record):
    """Solved instances over the seconds in which an operation of the
    window ran on the card; an unsolved one counts in no rate."""
    busy = record.window_busy_s
    if not busy or busy <= 0:
        return None
    return _solved(record) / busy


def percentile_90(record):
    """The 90th percentile of the calls' walls."""
    return float(np.percentile(record.walls, 90))


def mean_wall(record):
    """The window over the number of calls."""
    return sum(record.walls) / len(record.walls)


def admm_per_s(record):
    """ADMM iterations of every instance over the window."""
    return _admm(record.answers) / sum(record.walls)


def admm_per_instance(record):
    """Mean ADMM iterations of an instance."""
    return _admm(record.answers) / sum(a["status"].size
                                       for a in record.answers)


def idle_share(record):
    """Percent of the profiled calls' time in which no operation ran on
    the card."""
    p = record.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def roofline_share(record, kernels, flops_per_iteration):
    """Percent of the least time the card needs for the ADMM iterations
    the profiled calls' instances ran (their operations at the f32 peak,
    or the bytes each launch reads once, whichever is longer) over the
    device time of the kernels whose names contain one of `kernels`.
    None where the profile holds none of them."""
    p = record.profile
    if p is None:
        return None
    names = [k for k in p.kernel_s if any(s in k for s in kernels)]
    sec = sum(p.kernel_s[k] for k in names)
    if sec <= 0:
        return None
    answers = [a for _, a in p.calls]
    m, n = answers[0]["y"].shape[-1], answers[0]["x"].shape[-1]
    lanes = answers[0]["x"].shape[0]
    nbytes = sum(p.launches[k] for k in names) * lanes \
        * roofline.lane_bytes(m, n)
    bound, _ = roofline.bound_ms(nbytes, _admm(answers)
                                 * flops_per_iteration(m, n), "f32")
    return 100.0 * bound * 1e-3 / sec
