"""Conic KKT backends: Schur-complement solvers for the DR block system.

Port of `abip_tpu/linsys/schur.py`.  The projection step needs

    [[R_y,  A  ],   [z_y]   [w_y]
     [-A^T, Q+R_x]] [z_x] = [w_x]

(`form_qcp_kkt`, `qcp_config.c:699-748`).  Eliminating z_y gives the SPD
n x n Schur system S z_x = w_x + A^T R_y^-1 w_y with
S = Q + R_x + A^T R_y^-1 A; when H = Q + R_x is diagonal the m x m dual
(Woodbury) matrix G = R_y + A H^-1 A^T serves instead.

  * `DenseSchurSolver` -- one system per lane of a `(B, m, n)` stack (the
    host driver runs it at B=1).  Mode "chol" caches an f64 Cholesky
    factor; "newton" an explicit f64-quality inverse built from an f32
    Cholesky and Newton steps, applied with vector refinement (the
    factors the batched f32 kernels read); "inverse_mixed" applies the
    f32 inverse of the Jacobi-equilibrated S with three refinement steps
    against the f64 S, and the exact factor near the end.
  * `LowRankWoodburySolver` -- diagonal plus thin low-rank Gram, applied
    matrix-free.
  * `CGSchurSolver` -- matrix-free Jacobi-preconditioned CG on S with the
    reference's tolerance ladders (`pcg_tol_ladder`).

The last two solve one system on 1-D vectors, as the reference does.
Every `solve` returns `(z_y, z_x, iterations)` with the iteration count
a Python int.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import ieee_f32
from ..ops.admm_delta import _mv
from .cg import pcg

f32 = torch.float32


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device).expand(
        like.shape[0], k, k)


def _cholesky(M, what):
    """Cholesky factor of each SPD matrix of a stack; its `info` is read
    once, here at setup, and a matrix that is not positive definite
    raises."""
    L, info = torch.linalg.cholesky_ex(M)
    if bool((info != 0).any()):
        raise ValueError(f"{what} is not positive definite (is Q positive "
                         "semidefinite?)")
    return L


def _cho_apply(L, rhs):
    """Solve L L' z = rhs for `(..., k)` rhs and `(..., k, k)` factors."""
    return torch.cholesky_solve(rhs.unsqueeze(-1), L).squeeze(-1)


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
    """Dense Schur solver, one system per lane (`schur.py:69-203`).

    A `(B, m, n)`; Q a diagonal `(B, n)`, a full `(B, n, n)` or None;
    rho_y_vec `(B, m)` or `(m,)`, rho_x_vec `(B, n)` or `(n,)`.  `form`
    "woodbury" factors G (needs a diagonal H), "primal" factors S,
    "auto" picks Woodbury when H is diagonal and 4m <= 3n, for modes
    "chol" and "newton" (the reference's rule); "inverse_mixed" is
    defined on S only."""

    def __init__(self, A, Q, rho_y_vec, rho_x_vec, mode="chol",
                 form="auto", newton_steps=3):
        if mode not in ("chol", "inverse_mixed", "newton"):
            raise ValueError(f"unknown dense mode: {mode!r}")
        if form not in ("auto", "primal", "woodbury"):
            raise ValueError(f"unknown form: {form!r}")
        B, m, n = A.shape
        self.A = A
        self.Q = Q
        self.mode = mode
        self.newton_steps = newton_steps
        rho_y_vec = torch.broadcast_to(rho_y_vec, (B, m))
        rho_x_vec = torch.broadcast_to(rho_x_vec, (B, n))
        self.ry_inv = 1.0 / rho_y_vec
        q_diag = Q if (Q is not None and Q.dim() == 2) else None
        diagonal_H = Q is None or q_diag is not None
        if form == "woodbury" and not diagonal_H:
            raise ValueError("form='woodbury' requires Q diagonal or None")
        if form == "woodbury" and mode == "inverse_mixed":
            raise ValueError("mode='inverse_mixed' is defined on the "
                             "primal Schur complement S")
        woodbury = form == "woodbury" or (
            form == "auto" and mode in ("chol", "newton") and diagonal_H
            and 4 * m <= 3 * n)
        if woodbury:
            self.form = "woodbury"
            H = rho_x_vec + (q_diag if q_diag is not None else 0.0)
            self.H_inv = 1.0 / H
            G = (torch.diag_embed(rho_y_vec)
                 + (A * self.H_inv[:, None, :]) @ A.transpose(-1, -2))
            if mode == "newton":
                self.G64 = G
                self.Ginv64 = _newton_inverse(G, newton_steps)
            else:
                self.cholG = _cholesky(G, "G = R_y + A H^-1 A'")
            return
        self.form = "primal"
        S = ((A * self.ry_inv[:, :, None]).transpose(-1, -2) @ A
             + torch.diag_embed(rho_x_vec))
        if Q is not None:
            S = S + (torch.diag_embed(q_diag) if q_diag is not None else Q)
        if mode == "newton":
            self.S64n = S
            self.Sinv64 = _newton_inverse(S, newton_steps)
            return
        self.chol = _cholesky(S, "S = Q + R_x + A' R_y^-1 A")
        if mode == "inverse_mixed":
            # S's conditioning is dominated by 1/rho_y, far beyond f32:
            # Jacobi-equilibrate first (S_hat = D S D has unit diagonal),
            # invert S_hat in f64, keep the inverse in f32, and refine
            # against the f64 S (`schur.py:142-154`)
            self.S64 = S
            self.d_S = 1.0 / torch.sqrt(torch.diagonal(S, dim1=-2, dim2=-1))
            S_hat = S * self.d_S[:, :, None] * self.d_S[:, None, :]
            self.Shat_inv32 = torch.cholesky_solve(
                _eye(n, S), _cholesky(S_hat, "S_hat")).to(f32)

    @property
    def Minv64(self):
        """The explicit inverse the f32 kernels apply: G^-1 in the
        Woodbury form, S^-1 in the primal form (mode "newton" keeps it;
        mode "chol" computes it from the factor on each access)."""
        if self.mode == "newton":
            return self.Ginv64 if self.form == "woodbury" else self.Sinv64
        L = self.cholG if self.form == "woodbury" else self.chol
        return torch.cholesky_solve(_eye(L.shape[-1], L), L)

    def take(self, idx) -> "DenseSchurSolver":
        """The solver of the lanes `idx` (an index tensor; repeats
        allowed): every per-lane tensor indexed along its lane axis."""
        s = object.__new__(type(self))
        for k, v in vars(self).items():
            setattr(s, k, v[idx] if isinstance(v, torch.Tensor) else v)
        return s

    def _inv_mixed(self, r):
        """The f32 inverse of S_hat with three refinement steps against
        the f64 S (`schur.py:162-173`); the f32 product runs in IEEE f32,
        never TF32."""
        def once(rr):
            rh = (self.d_S * rr).to(f32)
            with ieee_f32():
                z = _mv(self.Shat_inv32, rh)
            return self.d_S * z.to(rr.dtype)

        z = once(r)
        for _ in range(3):
            z = z + once(r - _mv(self.S64, z))
        return z

    def _apply_inv(self, rhs, tol_hint=None):
        if self.mode == "newton":
            return _ir_apply(self.Sinv64, self.S64n, rhs)
        if self.mode == "inverse_mixed" and tol_hint is not None \
                and tol_hint > 100.0:
            # the bulk iterations ride the f32 inverse; once the error
            # ratio nears tolerance its noise floor would stall the inner
            # criterion, so the endgame and the setup solves (tol_hint
            # None) take the exact factor (`schur.py:178-186`)
            return self._inv_mixed(rhs)
        return _cho_apply(self.chol, rhs)

    def solve(self, w_y, w_x, iter_count=0, warm_start=None, tol_hint=None):
        """(z_y, z_x, 0) of the block system for `(B, m)`, `(B, n)` rhs.
        `tol_hint` is the error ratio as a host float (mode
        "inverse_mixed" switches on it), or None at setup."""
        A = self.A
        rhs = w_x + _mv(A.transpose(-1, -2), self.ry_inv * w_y)
        if self.form == "woodbury":
            t = self.H_inv * rhs
            At = _mv(A, t)
            u = (_ir_apply(self.Ginv64, self.G64, At) if self.mode == "newton"
                 else _cho_apply(self.cholG, At))
            z_x = t - self.H_inv * _mv(A.transpose(-1, -2), u)
            # A z_x = rho_y o u exactly (G u = A t)
            return self.ry_inv * w_y - u, z_x, 0
        z_x = self._apply_inv(rhs, tol_hint)
        return self.ry_inv * (w_y - _mv(A, z_x)), z_x, 0

    @classmethod
    def from_numpy(cls, dss, device=None) -> "DenseSchurSolver":
        """The reference's `DenseSchurSolver` (mode "newton" or "chol",
        leaves as numpy arrays, after `jax.device_get`; batched or one
        lane) as the port's."""
        if dss.mode not in ("newton", "chol"):
            raise ValueError(f"mode {dss.mode!r} is not converted")
        one_lane = np.ndim(dss.A) == 2

        def t(x):
            x = torch.from_numpy(np.array(x, dtype=np.float64)).to(device)
            return x.unsqueeze(0) if one_lane else x

        s = object.__new__(cls)
        s.mode, s.form, s.newton_steps = dss.mode, dss.form, dss.newton_steps
        s.A = t(dss.A)
        s.Q = None if dss.Q is None else t(dss.Q)
        s.ry_inv = t(dss.ry_inv)
        if s.form == "woodbury":
            s.H_inv = t(dss.H_inv)
            if s.mode == "newton":
                s.G64, s.Ginv64 = t(dss.G64), t(dss.Ginv64)
            else:
                s.cholG = t(dss.cholG)
        elif s.mode == "newton":
            s.S64n, s.Sinv64 = t(dss.S64n), t(dss.Sinv64)
        else:
            s.chol = t(dss.chol)
        return s


class LowRankWoodburySolver:
    """Direct Schur solve when A H^-1 A' = diag(g) + U Hu U' with a thin
    U (m x k, k << m) (`schur.py:247-286`; the reference's per-app
    custom KKT, `svm_config.c:577-637`).

    G = diag(rho_y + g) + U Hu U'; Sherman-Morrison-Woodbury gives

        G^-1 v = Dg^-1 v - Dg^-1 U C^-1 U' Dg^-1 v,
        C = Hu^-1 + U' Dg^-1 U            (k x k, factored once),

    so setup is O(m k^2) and each apply O(m k).  `solve` is the Woodbury
    form of `DenseSchurSolver.solve` on 1-D vectors, with A applied
    matrix-free (`op.matvec`/`op.rmatvec`)."""

    def __init__(self, op, H_inv_diag, rho_y_vec, U, Hu_diag, g_diag):
        self.op = op
        self.H_inv = H_inv_diag
        self.ry_inv = 1.0 / rho_y_vec
        self.U = U
        self.dg_inv = 1.0 / (rho_y_vec + g_diag)
        C = torch.diag(1.0 / Hu_diag) + (U * self.dg_inv[:, None]).T @ U
        self.cholC = _cholesky(C, "C = Hu^-1 + U' Dg^-1 U")

    def _Ginv(self, v):
        t = self.dg_inv * v
        s = _cho_apply(self.cholC, self.U.T @ t)
        return t - self.dg_inv * (self.U @ s)

    def solve(self, w_y, w_x, iter_count=0, warm_start=None, tol_hint=None):
        rhs = w_x + self.op.rmatvec(self.ry_inv * w_y)
        t = self.H_inv * rhs
        u = self._Ginv(self.op.matvec(t))
        z_x = t - self.H_inv * self.op.rmatvec(u)
        # G u = A t exactly (the decomposition is exact, not a
        # preconditioner), so z_y = ry_inv (w_y - A z_x) collapses
        z_y = self.ry_inv * w_y - u
        return z_y, z_x, 0


def pcg_tol_ladder(thresholds, coeffs):
    """An error-ratio-laddered PCG tolerance rule (`schur.py:289-314`).

    The coefficient is chosen by bucketing `error_ratio` (a host float)
    over the ascending `thresholds` (len(coeffs) must be
    len(thresholds) + 1); tol = max(1e-9, coef * norm_p / (k+1)^2), a
    tensor on norm_p's device."""
    th = np.asarray(thresholds, float)
    cf = np.asarray(coeffs, float)
    if cf.shape[0] != th.shape[0] + 1:
        raise ValueError("need len(coeffs) == len(thresholds) + 1")

    def ladder(k, error_ratio, norm_p):
        coef = float(cf[np.searchsorted(th, error_ratio, side="left")])
        return torch.clamp(coef * norm_p / (k + 1.0) ** 2, min=1e-9)

    return ladder


# `get_lasso_pcg_tol` (`lasso_config.c:592-619`)
LASSO_PCG_LADDER = pcg_tol_ladder(
    [10, 30, 100, 300, 1e3, 3e3, 1e4, 3e4, 1e5],
    [5e-4, 6e-4, 8e-4, 1.5e-3, 2e-3, 3e-3, 5e-3, 6e-3, 8e-3, 1.2e-2],
)

# `get_svm_pcg_tol` (`svm_config.c:669-696`)
SVM_PCG_LADDER = pcg_tol_ladder(
    [10, 30, 100, 300, 1e3, 3e3, 1e4, 3e4, 1e5],
    [4e-3, 7e-3, 1e-2, 1.3e-2, 1.6e-2, 2e-2, 2.5e-2, 3e-2, 3e-2, 3e-2],
)


class CGSchurSolver:
    """Matrix-free PCG on the Schur system (`schur.py:330-393`, the
    reference's `qcp_pcg`), on 1-D vectors: `linsys.cg.pcg` runs the
    same recurrence and reads the stop test once per CG iteration, so
    the iteration counts are the reference's."""

    def __init__(self, A_op, Q_op, rho_y_vec, rho_x_vec, diag_S,
                 max_iters=1000, tol_ladder=None):
        self.A_op = A_op      # LinearOperator (m, n)
        self.Q_op = Q_op      # callable x -> Qx, or None
        self.ry_inv = 1.0 / rho_y_vec
        self.rho_x = rho_x_vec
        self.M = 1.0 / diag_S  # Jacobi preconditioner (`init_qcp_precon`)
        self.max_iters = max_iters
        # per-problem tolerance rule (k, error_ratio, norm_p) -> tol;
        # default is the flat generic ladder of `get_qcp_pcg_tol`
        self.tol_ladder = tol_ladder

    def _S(self, x):
        y = self.A_op.matvec(x)
        out = self.A_op.rmatvec(self.ry_inv * y) + self.rho_x * x
        if self.Q_op is not None:
            out = out + self.Q_op(x)
        return out

    def solve(self, w_y, w_x, iter_count=0, warm_start=None, tol_hint=None):
        norm_p = torch.linalg.vector_norm(w_x)
        it = float(iter_count)
        if it < 0:
            tol = 1e-9 * norm_p
        elif self.tol_ladder is not None and tol_hint is not None:
            # per-app error-ratio ladder (`lasso_config.c:592-619`)
            tol = self.tol_ladder(it, tol_hint, norm_p)
        else:
            # `get_qcp_pcg_tol` (`qcp_config.c:786-793`)
            tol = torch.clamp(1e-5 * norm_p / (it + 1.0) ** 2, min=1e-9)
        rhs = w_x + self.A_op.rmatvec(self.ry_inv * w_y)
        x0 = warm_start if warm_start is not None else torch.zeros_like(w_x)
        z_x, iters = pcg(self._S, self.M, rhs, x0, tol, self.max_iters)
        z_y = self.ry_inv * (w_y - self.A_op.matvec(z_x))
        return z_y, z_x, iters
