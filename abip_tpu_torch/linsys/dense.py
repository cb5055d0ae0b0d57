"""Direct KKT backend: dense Cholesky of the normal equations.

Port of `abip_tpu/linsys/dense.py`: the reference's AMD+LDL' factorization
of the quasi-definite KKT (`src/abip-lp/linsys/direct.c:49-270`) becomes a
dense Cholesky of the m x m normal matrix

    N = rho_y * I + A A^T

factored once at setup and reused by two triangular solves per ADMM
iteration (`torch.linalg.cholesky`, `torch.cholesky_solve`: library
calls, which the reference also leaves to its framework).
"""
from __future__ import annotations

import torch


def cho_solve(chol, rhs):
    """x = (L L')^-1 rhs for a lower Cholesky factor `chol` and an (m,)
    right-hand side."""
    return torch.cholesky_solve(rhs[:, None], chol)[:, 0]


class DenseNormalSolver:
    """Cached-Cholesky solver for K z = w with K = [[rho_y I, A], [A^T, -I]]."""

    def __init__(self, A_op, m, n, rho_y, settings, normal_matrix=None):
        self.A_op = A_op
        self.m = m
        self.n = n
        self.rho_y = rho_y
        if normal_matrix is None:
            A = A_op.dense()
            normal_matrix = rho_y * torch.eye(m, dtype=A.dtype,
                                              device=A.device) + A @ A.T
        self.chol = torch.linalg.cholesky(normal_matrix)

    def solve(self, w_y, w_x, iter_count=0, warm_start=None):
        """Solve K z = (w_y, w_x); returns (z_y, z_x, aux_iters).

        Derivation (matches `indirect.c:393-434`):
            (rho_y I + A A^T) z_y = w_y + A w_x
            z_x = A^T z_y - w_x
        """
        rhs = w_y + self.A_op.matvec(w_x)
        z_y = cho_solve(self.chol, rhs)
        z_x = self.A_op.rmatvec(z_y) - w_x
        return z_y, z_x, 0
