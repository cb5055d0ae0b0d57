"""Indirect KKT backend: Jacobi-preconditioned conjugate gradients.

Port of `abip_tpu/linsys/cg.py`, the reference PCG backend
(`src/abip-lp/linsys/indirect.c:321-434`):

  * operator: G y = rho_y * y + A (A^T y)   (normal equations, matrix-free)
  * preconditioner: M = diag(G)^-1 = 1 / (rho_y + row_norms_sq(A))
    (`indirect.c:36-79`)
  * tolerance schedule: ||rhs|| * CG_MIN_TOL / (iter+1)^cg_rate, floored at
    1e-7; CG_BEST_TOL=1e-9 for the one-time setup solve (`indirect.c:406-409`)
  * warm start from the previous iterate (`indirect.c:344-352`)

The reference's `lax.while_loop` is a host loop here: the stop test
`||r|| >= tol` is read from the device once per CG iteration, so the
iteration count is exactly the reference's.
"""
from __future__ import annotations

import torch

CG_BEST_TOL = 1e-9
CG_MIN_TOL = 1e-1


def pcg(G, M, b, x0, tol, max_iters):
    """Jacobi-preconditioned CG: solve G(x) = b to ||r|| < tol.

    Mirrors `pcg` (`indirect.c:321-391`).  Returns (x, iterations) with
    the iteration count a Python int."""
    x = x0
    r = b - G(x)
    z = M * r
    p = z
    ipzr = (z * r).sum()
    i = 0
    while i < max_iters and bool(torch.linalg.vector_norm(r) >= tol):
        Gp = G(p)
        alpha = ipzr / (p * Gp).sum()
        x = x + alpha * p
        r = r - alpha * Gp
        z = M * r
        ipzr_new = (z * r).sum()
        p = z + (ipzr_new / ipzr) * p
        ipzr = ipzr_new
        i += 1
    return x, i


def cg_tolerance(rhs_norm, iter_count, cg_rate, dtype):
    """Decaying tolerance schedule (`indirect.c:406-409`); a 0-d tensor
    on `rhs_norm`'s device."""
    it = float(iter_count)
    sched = torch.tensor(
        CG_BEST_TOL if it < 0 else CG_MIN_TOL / (max(it, 0.0) + 1.0) ** cg_rate,
        dtype=dtype)
    return torch.clamp(rhs_norm * sched.to(rhs_norm.device), min=1e-7)


class CGSolver:
    """Matrix-free CG on (rho_y I + A A^T) z_y = w_y + A w_x."""

    def __init__(self, A_op, m, n, rho_y, settings):
        self.A_op = A_op
        self.m = m
        self.n = n
        self.rho_y = rho_y
        self.cg_rate = settings.cg_rate
        self.max_iters = min(settings.cg_max_iters, max(2 * m, 10))
        # Jacobi preconditioner: 1 / (rho_y + ||A_i,:||^2) per row.
        if A_op.has_dense:
            A = A_op.dense()
            row_sq = (A * A).sum(dim=1)
        else:
            # Operators that know their diagonal pass it via `row_norms_sq`;
            # otherwise the preconditioner is the identity scaled by 1/rho_y.
            row_sq = getattr(A_op, "row_norms_sq", None)
            if row_sq is None:
                row_sq = torch.zeros((m,), dtype=torch.float64)
        self.M = 1.0 / (rho_y + row_sq)

    def _G(self, y):
        return self.rho_y * y + self.A_op.matvec(self.A_op.rmatvec(y))

    def solve(self, w_y, w_x, iter_count=0, warm_start=None):
        """Solve K z = (w_y, w_x) via normal equations + PCG; returns
        (z_y, z_x, cg_iterations)."""
        rhs = w_y + self.A_op.matvec(w_x)
        tol = cg_tolerance(torch.linalg.vector_norm(rhs), iter_count,
                           self.cg_rate, rhs.dtype)
        x0 = warm_start if warm_start is not None else torch.zeros_like(w_y)
        z_y, iters = pcg(self._G, self.M.to(rhs.device), rhs, x0, tol,
                         self.max_iters)
        z_x = self.A_op.rmatvec(z_y) - w_x
        return z_y, z_x, iters
