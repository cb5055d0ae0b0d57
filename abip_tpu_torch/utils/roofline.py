"""Per-iteration cost model and speed-of-light estimate.

Port of `abip_tpu/utils/roofline.py`.  The reference C solver reports a
per-ADMM-iteration cost summary (avg linsys solve time, nnz in the
factor, `src/abip-lp/linsys/direct.c:15-26`).  The roofline analogue:
each ADMM iteration streams the problem matrix a fixed number of times
and does a fixed number of operations, so the card's memory rate (the
usual bound: these products sit far below the arithmetic intensity the
card's peak needs) and its peak rate imply a ceiling on the iteration
rate.  A bench reports measured/ceiling, so that a regression in the
hot loop shows as a falling fraction, whatever the problem size.

The byte and operation counts are the reference's.  The chip constants
are nominal public specs; pass `chip=` to pick another.  The model
counts HBM traffic only: kernels that keep A in shared memory across
iterations (K1's cluster per lane) can beat its ceiling.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# nominal public specs
CHIPS = {
    # NVIDIA's H100 SXM data sheet: HBM3 bandwidth and the f32 and f64
    # peaks outside the tensor cores, at the full 700 W power limit
    "h100": {"hbm_gbps": 3350.0, "f32_tflops": 67.0, "f64_tflops": 34.0},
    # generic 4-core desktop-class CPU (DDR4-ish), the reference's entry:
    # keeps the fraction meaningful for a CPU run
    "cpu": {"hbm_gbps": 25.0, "f32_tflops": 0.2, "f64_tflops": 0.05},
}


@dataclass
class IterationCost:
    bytes_moved: float           # per ADMM iteration
    flops: float
    ceiling_iters_per_sec_bw: float
    ceiling_iters_per_sec_flops: float

    @property
    def ceiling_iters_per_sec(self) -> float:
        return min(self.ceiling_iters_per_sec_bw,
                   self.ceiling_iters_per_sec_flops)


def _cost(bytes_moved, flops, itemsize, chip) -> IterationCost:
    spec = CHIPS[chip]
    bw = spec["hbm_gbps"] * 1e9
    fl = spec["f64_tflops" if itemsize == 8.0 else "f32_tflops"] * 1e12
    return IterationCost(
        bytes_moved=bytes_moved, flops=flops,
        ceiling_iters_per_sec_bw=bw / bytes_moved,
        ceiling_iters_per_sec_flops=fl / flops,
    )


def lp_iteration_cost(m: int, n: int, precision: str = "mixed",
                      qres_period: int = 1, avg_period: int = 10,
                      chip: str = "h100") -> IterationCost:
    """Cost of one dense-path ADMM iteration of `device_solve_lp`.

    Counts the dominant terms: the projection streams A twice (forward
    and transpose product) and the inner criterion streams it twice
    every `qres_period`-th iteration; the KKT apply is an m x m
    matrix-vector product; vector work is O(m + n), negligible against A
    for n >> m.
    """
    itemsize = 4.0 if precision in ("mixed", "f32") else 8.0
    a_bytes = itemsize * m * n
    # streams of A per iteration: 2 for the projection, plus the inner
    # criterion (2) whenever (j % qres_period == 0) or
    # (j % avg_period == 0) -- the solver always evaluates the averaged
    # candidate every avg_period-th iteration -- plus the averaged-
    # candidate criterion (2) and the residual check (2) on the
    # every-avg_period-th iterations
    P = max(1, qres_period)
    Pa = max(1, avg_period)
    freq_a = 1.0 / Pa
    freq_q = 1.0 / P + freq_a - 1.0 / math.lcm(P, Pa)
    streams = 2.0 + 2.0 * freq_q + (2.0 + 2.0) * freq_a
    bytes_moved = streams * a_bytes + itemsize * (m * m)   # + KKT apply
    flops = streams * 2.0 * m * n + 2.0 * m * m
    return _cost(bytes_moved, flops, itemsize, chip)


def qcp_iteration_cost(m: int, n: int, precision: str = "mixed",
                       inner_crit_period: int = 1, form: str = "auto",
                       chip: str = "h100") -> IterationCost:
    """Cost of one ADMM iteration of the conic device route
    (`solve_qcp_device`), the conic analogue of `lp_iteration_cost`
    (the reference C solver's per-iteration report: `source/linsys.c:71-97`).

    Dominant terms: the DR projection streams A twice and applies the
    cached Schur inverse (k x k, k = m under the Woodbury dual form when
    2m <= n with diagonal H, else n); the HSD inner convergence check
    streams A twice every `inner_crit_period`-th iteration; the cone
    prox is O(n) segment work and negligible.
    """
    itemsize = 4.0 if precision in ("mixed", "f32") else 8.0
    a_bytes = itemsize * m * n
    k = m if (form == "dual" or (form == "auto" and 2 * m <= n)) else n
    P = max(1, inner_crit_period)
    streams = 2.0 + 2.0 / P
    bytes_moved = streams * a_bytes + itemsize * (k * k)
    flops = streams * 2.0 * m * n + 2.0 * k * k
    return _cost(bytes_moved, flops, itemsize, chip)
