"""Basic LP: min c'x s.t. Ax = b, x >= 0.

Run: python abip_tpu_torch/examples/01_lp.py [--cpu]
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
m, n = 30, 120
A = rng.standard_normal((m, n))
b = A @ (rng.random(n) + 0.5)           # feasible by construction
c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5

sol = abip_tpu_torch.solve_lp(A, b, c, eps=1e-6, verbose=True, device=device)
print(f"\n{sol.status_name}: pobj={sol.pobj:.6f} in "
      f"{sol.ipm_iters} IPM / {sol.admm_iters} ADMM iterations")
