"""Dense Schur-complement solver for the conic DR block system, batched.

Port of `abip_tpu/linsys/schur.py:29-203` in `mode="newton"`.  The
projection step needs

    [[R_y,  A  ],   [z_y]   [w_y]
     [-A^T, Q+R_x]] [z_x] = [w_x]

(`form_qcp_kkt`, `qcp_config.c:699-748`).  Eliminating z_y gives the SPD
n x n Schur system S z_x = w_x + A^T R_y^-1 w_y with
S = Q + R_x + A^T R_y^-1 A; when H = Q + R_x is diagonal the m x m dual
(Woodbury) matrix G = R_y + A H^-1 A^T serves instead.  The factor is an
explicit f64-quality inverse built from an f32 Cholesky and Newton
steps, applied with vector iterative refinement against the f64
matrix.  Everything is batched over a leading lane axis; Q is a
diagonal `(B, n)` or absent.  Modes "chol"/"inverse_mixed", the
low-rank and CG solvers are not ported yet (ROADMAP.md queue 1, item 8).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.admm_delta import _mv

f32 = torch.float32


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device).expand(
        like.shape[0], k, k)


def _newton_inverse(S, steps=3):
    """f64-quality explicit inverse of each `(k, k)` SPD matrix of the
    `(B, k, k)` stack without f64 triangular solves: Jacobi-equilibrate
    (unit diagonal), invert in f32 through Cholesky, then Newton steps
    X <- X + X(I - S_hat X) against the f64 S_hat, each squaring the
    residual."""
    d = 1.0 / torch.sqrt(torch.diagonal(S, dim1=-2, dim2=-1))
    S_hat = S * d[:, :, None] * d[:, None, :]
    k = S.shape[-1]
    L = torch.linalg.cholesky(S_hat.to(f32))
    X = torch.cholesky_solve(_eye(k, L), L).to(S.dtype)
    eye = _eye(k, S)
    for _ in range(steps):
        X = X + X @ (eye - S_hat @ X)
    return X * d[:, :, None] * d[:, None, :]


def _ir_apply(Minv, M, rhs, steps=2):
    """Solve from an explicit inverse plus `steps` vector refinement
    steps against the f64 matrix (an inverse apply alone is not
    backward stable)."""
    z = _mv(Minv, rhs)
    for _ in range(steps):
        z = z + _mv(Minv, rhs - _mv(M, z))
    return z


class DenseSchurSolver:
    """Newton-inverse Schur solver, one system per lane.

    A `(B, m, n)`; Q a diagonal `(B, n)` or None; rho_y_vec `(B, m)` or
    `(m,)`, rho_x_vec `(B, n)` or `(n,)`.  `form` "woodbury" factors G
    (needs a diagonal H), "primal" factors S, "auto" picks Woodbury when
    4m <= 3n (the reference's rule)."""

    def __init__(self, A, Q, rho_y_vec, rho_x_vec, mode="newton",
                 form="auto", newton_steps=3):
        if mode != "newton":
            raise NotImplementedError(
                f"DenseSchurSolver mode={mode!r} is not ported to "
                "abip_tpu_torch yet (ROADMAP.md queue 1, item 8)")
        if form not in ("auto", "primal", "woodbury"):
            raise ValueError(f"unknown form: {form!r}")
        if Q is not None and Q.dim() != 2:
            raise NotImplementedError(
                "a full (n, n) Q is not ported to abip_tpu_torch yet "
                "(ROADMAP.md queue 1, item 11)")
        B, m, n = A.shape
        self.A = A
        self.Q = Q
        self.mode = mode
        self.newton_steps = newton_steps
        rho_y_vec = torch.broadcast_to(rho_y_vec, (B, m))
        rho_x_vec = torch.broadcast_to(rho_x_vec, (B, n))
        self.ry_inv = 1.0 / rho_y_vec
        woodbury = form == "woodbury" or (form == "auto" and 4 * m <= 3 * n)
        if woodbury:
            self.form = "woodbury"
            H = rho_x_vec + (Q if Q is not None else 0.0)
            self.H_inv = 1.0 / H
            self.G64 = (torch.diag_embed(rho_y_vec)
                        + (A * self.H_inv[:, None, :]) @ A.transpose(-1, -2))
            self.Ginv64 = _newton_inverse(self.G64, newton_steps)
            return
        self.form = "primal"
        S = ((A * self.ry_inv[:, :, None]).transpose(-1, -2) @ A
             + torch.diag_embed(rho_x_vec))
        if Q is not None:
            S = S + torch.diag_embed(Q)
        self.S64n = S
        self.Sinv64 = _newton_inverse(S, newton_steps)

    @property
    def Minv64(self):
        """The explicit inverse the f32 kernels apply: G^-1 in the
        Woodbury form, S^-1 in the primal form."""
        return self.Ginv64 if self.form == "woodbury" else self.Sinv64

    def solve(self, w_y, w_x):
        """(z_y, z_x) of the block system for `(B, m)`, `(B, n)` rhs."""
        A = self.A
        rhs = w_x + _mv(A.transpose(-1, -2), self.ry_inv * w_y)
        if self.form == "woodbury":
            t = self.H_inv * rhs
            u = _ir_apply(self.Ginv64, self.G64, _mv(A, t))
            z_x = t - self.H_inv * _mv(A.transpose(-1, -2), u)
            # A z_x = rho_y o u exactly (G u = A t)
            return self.ry_inv * w_y - u, z_x
        z_x = _ir_apply(self.Sinv64, self.S64n, rhs)
        return self.ry_inv * (w_y - _mv(A, z_x)), z_x

    @classmethod
    def from_numpy(cls, dss, device=None) -> "DenseSchurSolver":
        """The reference's `DenseSchurSolver` (mode "newton", leaves as
        numpy arrays, after `jax.device_get`; batched or one lane) as
        the port's."""
        if dss.mode != "newton":
            raise NotImplementedError(f"mode {dss.mode!r} is not ported")

        def t(x, k):
            x = torch.from_numpy(np.array(x, dtype=np.float64)).to(device)
            return x if x.dim() == k else x.unsqueeze(0)

        s = object.__new__(cls)
        s.mode, s.form, s.newton_steps = dss.mode, dss.form, dss.newton_steps
        s.A = t(dss.A, 3)
        s.Q = None if dss.Q is None else t(dss.Q, 2)
        s.ry_inv = t(dss.ry_inv, 2)
        if s.form == "woodbury":
            s.H_inv, s.G64, s.Ginv64 = (t(dss.H_inv, 2), t(dss.G64, 3),
                                        t(dss.Ginv64, 3))
        else:
            s.S64n, s.Sinv64 = t(dss.S64n, 3), t(dss.Sinv64, 3)
        return s
