"""Parametric serving: one factorization, many solves.

The reference splits `ABIP(init)`/`ABIP(solve)` so one factorization
serves repeated solves with new data (`include/abip.h:116-123`); here
that is `LPWorkspace.update_problem(b, c)` -- the Cholesky factor of the
normal matrix persists across ticks.  A drifting-demand LP family is
re-solved each "tick" with a warm seed from the previous optimum.

Warm seeds do not shorten the IPM mu path for this method (skipping
stages makes the ADMM inner subproblems harder), so the per-tick win
comes from setup reuse and slightly easier stages, not from a shorter
path.  The latencies are host walls of whole solves, whose results are
read back, on the device named in the last line.

Run: python abip_tpu_torch/examples/08_parametric_serving.py [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import abip_tpu_torch  # noqa: E402
from abip_tpu_torch.lp import LPWorkspace  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--cpu", action="store_true",
                help="run on the CPU (default: the CUDA card)")
device = "cpu" if ap.parse_args().cpu else None
where = "CPU" if device else torch.cuda.get_device_name(0)

rng = np.random.default_rng(0)
m, n = 40, 400
A = np.concatenate(
    [rng.standard_normal((m, n - m)) * (rng.random((m, n - m)) < 0.3),
     np.eye(m)], axis=1)
b0 = A @ (rng.random(n) + 0.5)
c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
TICKS = 10

w = LPWorkspace(A, b0, c, abip_tpu_torch.Settings(eps=1e-6, adaptive=False),
                device=device)
prev = w.solve()
w.update_problem(b0 * 1.001, c)   # a first tick off the clock (warm-up)
w.solve(warm=(prev.x, prev.y, prev.s))

t0 = time.perf_counter()
for k in range(TICKS):
    b_k = b0 * (1.0 + 0.02 * np.sin(0.3 * (k + 1)))
    w.update_problem(b_k, c)
    prev = w.solve(warm=(prev.x, prev.y, prev.s))
    if prev.status_name != "Solved":
        raise SystemExit(f"tick {k}: {prev.status_name}")
served = (time.perf_counter() - t0) / TICKS

t0 = time.perf_counter()
for k in range(TICKS):
    b_k = b0 * (1.0 + 0.02 * np.sin(0.3 * (k + 1)))
    s_k = abip_tpu_torch.solve_lp(A, b_k, c, eps=1e-6, adaptive=False,
                                  device=device)
    if s_k.status_name != "Solved":
        raise SystemExit(f"tick {k} from scratch: {s_k.status_name}")
cold = (time.perf_counter() - t0) / TICKS

print(f"per-tick latency: served (factor reuse + warm) {served * 1e3:.0f}ms"
      f" vs from-scratch {cold * 1e3:.0f}ms -> {cold / served:.2f}x "
      f"[{where}]")
