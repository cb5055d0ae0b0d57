"""Differentiating THROUGH the solver (the diffcp role).

`abip_tpu_torch.solve_lp_grad` is the solution map (A, b, c) -> (x, y, s)
as a `torch.autograd` function (implicit differentiation at the KKT
system, see abip_tpu_torch/diff.py).  This example:

  1. checks the envelope theorem: d(c'x*)/db equals the dual y* (the
     LP's shadow prices), by torch.autograd.grad through a solve;
  2. computes the full sensitivity matrix dx*/db with
     torch.autograd.functional.jacobian;
  3. runs a few steps of gradient descent ON THE PROBLEM DATA b
     (resource allocation) to cut the optimal cost under a quadratic
     adjustment penalty -- an optimization layer, LP inside.

Run: python abip_tpu_torch/examples/06_diff.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import abip_tpu_torch  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--cpu", action="store_true",
                help="run on the CPU (default: the CUDA card)")
dev = torch.device("cpu" if ap.parse_args().cpu else "cuda")

rng = np.random.default_rng(0)
m, n = 10, 30
A_np = rng.standard_normal((m, n))
b_np = A_np @ (rng.random(n) + 0.5)
c_np = A_np.T @ rng.standard_normal(m) + rng.random(n) + 0.5
A, b0, c = (torch.as_tensor(v, dtype=torch.float64, device=dev)
            for v in (A_np, b_np, c_np))


def xstar(b):
    return abip_tpu_torch.solve_lp_grad(A, b, c, eps=1e-9, device=dev)[0]


# 1. shadow prices: grad of the optimal value w.r.t. the rhs is the dual
x, y, s = abip_tpu_torch.solve_lp_grad(A, b0, c, eps=1e-9, device=dev)
b = b0.clone().requires_grad_(True)
grad_b, = torch.autograd.grad(c @ xstar(b), b)
print("envelope check  max|d(c'x)/db - y*| =",
      float((grad_b - y).abs().max()))

# 2. full solution sensitivity dx*/db (n x m), one jacobian call
J = torch.autograd.functional.jacobian(xstar, b0)
print("sensitivity dx*/db:", tuple(J.shape), " nonzero rows:",
      int((J.abs() > 1e-9).any(dim=1).sum()))


# 3. tune the resources: minimize optimal cost + adjustment penalty
def outer_loss(b):
    return c @ xstar(b) + 5.0 * ((b - b0) ** 2).sum()


b = b0
for it in range(5):
    b = b.detach().requires_grad_(True)
    val = outer_loss(b)
    g, = torch.autograd.grad(val, b)
    b = b.detach() - 0.02 * g
    print(f"outer step {it}: loss={float(val.detach()):.6f}  |grad|="
          f"{float(torch.linalg.norm(g)):.4f}")
print("optimal cost moved", float(c @ x), "->", float(c @ xstar(b)))
