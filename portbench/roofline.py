"""Peaks of the card and the least time a kernel's work can take.

`bound_ms` is a frozen copy of `chip_smoke.py:3545-3555` (`HBM_BYTES_S`,
`PEAK_FLOPS`, `bound_ms`): NVIDIA's H100 SXM data sheet, dense rates
outside the tensor cores.  The operation counts per ADMM iteration are
those of `chip_smoke.py:508-509` (K1) and the kernel table of `PERF.md`
(K2, K3); they follow from the problem's shapes, never from the
implementation.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}


def bound_ms(nbytes, flops, kind):
    """(least milliseconds the card needs, what bounds it): bytes over the
    memory rate against operations over the peak of their type."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[kind]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def lp_delta_flops(m, n, probe=8):
    """One K1 iteration of one lane: A'dz and A dwx (4mn), the m x m
    inverse of the normal matrix (2m^2), and every `probe` iterations
    four more passes over A for the criteria (8mn / probe)."""
    return 4 * m * n + 2 * m * m + 8 * m * n / probe


def conic_dr_flops(m, n, probe=8):
    """One K2 or K3 iteration of one lane at the lower of the two counts:
    four passes over A (8mn), the m x m Schur inverse (2m^2) and two more
    passes every `probe` iterations (4mn / probe)."""
    return 8 * m * n + 2 * m * m + 4 * m * n / probe


def lane_bytes(m, n):
    """f32 bytes one launch reads once for one lane: A (m x n), the m x m
    operator and eight state vectors of length m + n + 1.  A lower count
    of what the kernels read, so the bound stays a bound."""
    return 4 * (m * n + m * m + 8 * (m + n + 1))
