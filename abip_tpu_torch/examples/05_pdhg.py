"""Restarted PDHG (the PDLP-style first-order competitor) on a random LP.

The same standard form as `solve_lp`; `precision="mixed"` runs the f32
hot loop anchored by f64 restarts and checks.

Run: python abip_tpu_torch/examples/05_pdhg.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import numpy as np  # noqa: E402

import abip_tpu_torch  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--cpu", action="store_true",
                help="run on the CPU (default: the CUDA card)")
device = "cpu" if ap.parse_args().cpu else None

rng = np.random.default_rng(0)
m, n = 50, 200
A = rng.standard_normal((m, n))
b = A @ (rng.random(n) + 0.5)
c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5

sol = abip_tpu_torch.solve_lp_pdhg(A, b, c, eps=1e-6, precision="mixed",
                                   device=device)
print(f"PDHG : {sol.status_name} in {sol.admm_iters} iterations, "
      f"pobj={sol.pobj:.8f}")

ref = abip_tpu_torch.solve_lp(A, b, c, eps=1e-6, device=device)
print(f"ABIP : {ref.status_name} in {ref.admm_iters} ADMM iterations, "
      f"pobj={ref.pobj:.8f}")
print(f"objective agreement: {abs(sol.pobj - ref.pobj):.2e}")
