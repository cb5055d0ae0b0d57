"""A LASSO regularization-path sweep as ONE batched solve.

Run: python abip_tpu_torch/examples/03_lasso_sweep.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import numpy as np  # noqa: E402

from abip_tpu_torch.problems.lasso import solve_lasso_batch  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--cpu", action="store_true",
                help="run on the CPU (default: the CUDA card)")
device = "cpu" if ap.parse_args().cpu else None

rng = np.random.default_rng(2)
m, n, B = 40, 15, 6
X = rng.standard_normal((m, n))
w_true = np.zeros(n)
w_true[:3] = [2.0, -1.0, 0.5]
y = X @ w_true + 0.05 * rng.standard_normal(m)

lams = np.geomspace(0.05, 2.0, B)
Xs = np.broadcast_to(X, (B, m, n))
ys = np.broadcast_to(y, (B, m))
W, objs, res = solve_lasso_batch(Xs, ys, lams, eps=1e-5, device=device)
for lam, w, obj in zip(lams, W, objs):
    nnz = int((np.abs(w) > 1e-4).sum())
    print(f"lambda={lam:6.3f}: obj={obj:8.4f} nnz={nnz}")
