"""Risk-bounded portfolio as an SOCP: min -mu'w + gamma*||F w||.

Run: python abip_tpu_torch/examples/02_portfolio_socp.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import numpy as np  # noqa: E402

import abip_tpu_torch  # noqa: E402
from abip_tpu_torch import ConeSpec  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--cpu", action="store_true",
                help="run on the CPU (default: the CUDA card)")
device = "cpu" if ap.parse_args().cpu else None

rng = np.random.default_rng(1)
k = 8                                    # assets
F = rng.standard_normal((k, k)) / np.sqrt(k)   # factor loadings
mu_ret = rng.random(k)

# variables z = (t, u[k], w[k]); cones: SOC(1+k) over (t, u), nonneg w
# rows: sum w = 1;  F w - u = 0
n = 1 + 2 * k
A = np.zeros((1 + k, n))
A[0, 1 + k:] = 1.0
A[1:, 1:1 + k] = -np.eye(k)
A[1:, 1 + k:] = F
b = np.zeros(1 + k)
b[0] = 1.0
c = np.zeros(n)
c[0] = 2.0
c[1 + k:] = -mu_ret

sol = abip_tpu_torch.solve_qcp(A, b, c, ConeSpec(soc=(1 + k,), nonneg=k),
                               eps=1e-5, device=device)
w = sol.x[1 + k:]
print(f"{sol.status_name}: weights={np.round(w, 3)} risk={sol.x[0]:.4f}")
