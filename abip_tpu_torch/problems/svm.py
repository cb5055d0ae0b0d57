"""Support-vector machine: hinge loss, QP and SOCP conic forms.

    min_{w,b0}  (1/2)||w||^2 + C * sum_i max(0, 1 - y_i (x_i'w + b0))

Port of `abip_tpu/problems/svm.py`, the reference's pair of configs:

QP form (`source/svm_qp_config.c:8-60`: p = m rows, Q = diag(I_n, 0)):
    variables  z = (w in R^n, b0, xi in R^m, t in R^m)
    cones      free^{n+1} x R+^{2m}
    rows       y_i x_i'w + y_i b0 + xi_i - t_i = 1
    objective  min (1/2) z'Q z + C 1'xi,   Q = diag(I_n, 0, 0, 0)

SOCP form (`source/svm_config.c:8-60`): the quadratic becomes an RSOC
epigraph ||w||^2 <= 2 r s with s = 1:
    variables  z = (r, s, w in R^n, b0, xi in R^m, t in R^m)
    cones      RSOC(2+n) x free^1 x R+^{2m}
    rows       s = 1;  y_i x_i'w + y_i b0 + xi_i - t_i = 1
    objective  min r + C 1'xi
"""
from __future__ import annotations

import numpy as np
import torch

from ..cones import ConeSpec
from ..device import resolve_device
from .lasso import ConicProblem


def _check(X, y):
    X = np.asarray(X, float)
    y = np.asarray(y, float)
    m, n = X.shape
    if y.shape != (m,):
        raise ValueError(f"y must have shape ({m},); got {y.shape}")
    if not np.all(np.isin(y, (-1.0, 1.0))):
        raise ValueError("labels y must be +/-1")
    return X, y, m, n


def _recover(X, y, C, m, n, w_at, scale=None):
    """(w, b0, objective) from a solution whose w block starts at
    `w_at`; `scale` un-scales an operator form's solution."""
    def recover(sol):
        z = np.asarray(sol.x)
        if scale is not None:
            z = z / scale
        w, b0 = z[w_at:w_at + n], z[w_at + n]
        margins = 1 - y * (X @ w + b0)
        obj = 0.5 * w @ w + C * np.sum(np.maximum(margins, 0))
        return w, b0, obj

    return recover


def svm_to_conic_qp(X, y, C: float) -> ConicProblem:
    X, y, m, n = _check(X, y)
    q = n + 1 + 2 * m
    A = np.zeros((m, q))
    A[:, :n] = y[:, None] * X        # label-folded data (`svm_config.c:121-124`)
    A[:, n] = y
    A[:, n + 1:n + 1 + m] = np.eye(m)
    A[:, n + 1 + m:] = -np.eye(m)
    b = np.ones(m)
    c = np.zeros(q)
    c[n + 1:n + 1 + m] = C
    Q = np.zeros((q, q))
    Q[:n, :n] = np.eye(n)
    cones = ConeSpec(free=n + 1, nonneg=2 * m)
    return ConicProblem(A=A, b=b, c=c, cones=cones,
                        recover=_recover(X, y, C, m, n, 0), Q=Q)


def svm_to_conic_socp(X, y, C: float) -> ConicProblem:
    X, y, m, n = _check(X, y)
    q = 2 + n + 1 + 2 * m
    p = 1 + m
    A = np.zeros((p, q))
    A[0, 1] = 1.0                      # s = 1
    A[1:, 2:2 + n] = y[:, None] * X
    A[1:, 2 + n] = y
    A[1:, 3 + n:3 + n + m] = np.eye(m)
    A[1:, 3 + n + m:] = -np.eye(m)
    b = np.concatenate([[1.0], np.ones(m)])
    c = np.zeros(q)
    c[0] = 1.0
    c[3 + n:3 + n + m] = C
    cones = ConeSpec(rsoc=(2 + n,), free=1, nonneg=2 * m)
    return ConicProblem(A=A, b=b, c=c, cones=cones,
                        recover=_recover(X, y, C, m, n, 2))


def _normalized_bc(b, c, D, E):
    """b/c normalization of the dense pipeline
    (`scaling_qcp_data:462-485`)."""
    sc = float(np.sqrt(np.sqrt(b @ b + c @ c)))
    sc = 1.0 if sc < 1e-3 else min(sc, 1e3)
    sc_b = sc_c = 1.0 / sc
    return b / D * sc_b, c / E * sc_c, sc_b


def svm_operator_qp(X, y, C: float, scaled: bool = True,
                    device=None) -> ConicProblem:
    """Matrix-free QP form: the label-folded data applied on the fly, as
    tensors on `device` (default: the CUDA card), like the reference's
    `svm_A_times`/`svm_AT_times` (`source/svm_config.c:175-229`).  Q is
    the diagonal (1_n, 0, 0, 0).

    `scaled=True` applies the analytic equilibration (closed-form row
    and column norms of [yX, y, I, -I]), the role of the reference's
    shape heuristics (`svm_config.c:64-111`); Q transforms as E^-2.  The
    KKT solve is `LowRankWoodburySolver`: the scaled Gram A H^-1 A' is
    exactly diagonal plus rank n+1 (`svm_config.c:577-637`)."""
    from ..linsys.schur import LowRankWoodburySolver
    from ..problem import LinearOperator

    dev = resolve_device(device)
    X, y, m, n = _check(X, y)
    q = n + 1 + 2 * m

    # analytic norms: rows ||X_i||^2 + 3; cols [||X_:j||^2, m, 1_m, 1_m]
    row_sq = np.sum(X * X, axis=1) + 3.0
    col_sq = np.concatenate([np.sum(X * X, axis=0), [float(m)],
                             np.ones(2 * m)])
    if scaled:
        D = np.sqrt(np.sqrt(row_sq))
        E = np.sqrt(np.sqrt(np.maximum(col_sq, 1e-8)))
    else:
        D = np.ones(m)
        E = np.ones(q)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    Xt, yt, Dt, Et = t(X), t(y), t(D), t(E)

    def matvec(z):
        z = z / Et
        w, b0 = z[:n], z[n]
        xi, tt = z[n + 1:n + 1 + m], z[n + 1 + m:]
        return (yt * (Xt @ w) + yt * b0 + xi - tt) / Dt

    def rmatvec(u):
        u = u / Dt
        return torch.cat([Xt.T @ (yt * u), (yt @ u)[None], u, -u]) / Et

    op = LinearOperator(m, q, matvec, rmatvec, nnz=m * n + 3 * m)
    # the exact Jacobi diagonal of the scaled operator's A-part
    Xd_sq = np.sum((X / D[:, None]) ** 2, axis=0)
    exact_col = np.concatenate(
        [Xd_sq, [float(np.sum(1.0 / D ** 2))], 1.0 / D ** 2, 1.0 / D ** 2])
    op.col_norms_sq = exact_col / (E * E)

    b = np.ones(m)
    c = np.zeros(q)
    c[n + 1:n + 1 + m] = C
    b_s, c_s, sc_b = _normalized_bc(b, c, D, E)
    Q_diag = np.concatenate([np.ones(n), np.zeros(1 + 2 * m)]) / (E * E)
    cones = ConeSpec(free=n + 1, nonneg=2 * m)

    def solver_factory(op_, rho_y_vec, rho_x_vec, Q_diag_s):
        H = rho_x_vec + (Q_diag_s if Q_diag_s is not None else 0.0)
        H_inv = 1.0 / H
        ht = H_inv / (Et * Et)
        U = (yt[:, None] * torch.cat(
            [Xt, torch.ones((m, 1), dtype=Xt.dtype, device=dev)], dim=1)
            ) / Dt[:, None]
        U = U * torch.sqrt(ht[:n + 1])[None, :]
        Hu = torch.ones((n + 1,), dtype=Xt.dtype, device=dev)
        g = (ht[n + 1:n + 1 + m] + ht[n + 1 + m:]) / (Dt * Dt)
        return LowRankWoodburySolver(op_, H_inv, rho_y_vec, U, Hu, g)

    return ConicProblem(A=op, b=b_s, c=c_s, cones=cones,
                        recover=_recover(X, y, C, m, n, 0, E * sc_b),
                        Q=Q_diag, solver_factory=solver_factory)


def svm_operator_socp(X, y, C: float, scaled: bool = True,
                      device=None) -> ConicProblem:
    """Matrix-free SOCP form: the reformulated constraint matrix

        A = [[0, 1, 0,  0, 0,  0],          z = (r, s, w, b0, xi, t)
             [0, 0, yX, y, I, -I]]

    is never formed; X is applied on the fly over scaled blocks, as
    tensors on `device` (default: the CUDA card) (`svm_config.c:175-196`
    `svm_A_times`, `:202-229` `svm_AT_times`, `:577-637` the custom KKT,
    `:642-664` the preconditioner).  `scaled=True` applies the analytic
    equilibration (E tied over the RSOC block); the exact Jacobi
    diagonal and the SVM PCG ladder (`get_svm_pcg_tol`,
    `svm_config.c:669-696`) come with it."""
    from ..linsys.schur import SVM_PCG_LADDER, LowRankWoodburySolver
    from ..problem import LinearOperator

    dev = resolve_device(device)
    X, y, m, n = _check(X, y)
    p = 1 + m
    q = 2 + n + 1 + 2 * m

    row_sq = np.concatenate([[1.0], np.sum(X * X, axis=1) + 3.0])
    col_sq = np.concatenate([[0.0, 1.0], np.sum(X * X, axis=0), [float(m)],
                             np.ones(2 * m)])
    if scaled:
        D = np.sqrt(np.sqrt(row_sq))
        E = np.sqrt(np.sqrt(np.maximum(col_sq, 1e-8)))
        # tie E over the RSOC block (r, s, w) like the conic pipeline
        E[:2 + n] = E[:2 + n].mean()
    else:
        D = np.ones(p)
        E = np.ones(q)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    Xt, yt, Dt, Et = t(X), t(y), t(D), t(E)

    def matvec(z):
        z = z / Et
        w, b0 = z[2:2 + n], z[2 + n]
        xi, tt = z[3 + n:3 + n + m], z[3 + n + m:]
        rows = yt * (Xt @ w) + yt * b0 + xi - tt
        return torch.cat([z[1:2], rows]) / Dt

    def rmatvec(u):
        u = u / Dt
        ur = u[1:]
        return torch.cat([torch.zeros_like(u[:1]), u[:1], Xt.T @ (yt * ur),
                          (yt @ ur)[None], ur, -ur]) / Et

    op = LinearOperator(p, q, matvec, rmatvec, nnz=m * n + 3 * m + 1)
    # the exact Jacobi diagonal of the scaled operator (`init_svm_precon`,
    # `svm_config.c:642-664`: per-column sums over row-scaled entries)
    Dr = D[1:]
    Xd_sq = np.sum((X / Dr[:, None]) ** 2, axis=0)
    exact_col = np.concatenate([
        [0.0, 1.0 / D[0] ** 2], Xd_sq, [float(np.sum(1.0 / Dr ** 2))],
        1.0 / Dr ** 2, 1.0 / Dr ** 2])
    op.col_norms_sq = exact_col / (E * E)

    b = np.concatenate([[1.0], np.ones(m)])
    c = np.zeros(q)
    c[0] = 1.0
    c[3 + n:3 + n + m] = C
    b_s, c_s, sc_b = _normalized_bc(b, c, D, E)
    cones = ConeSpec(rsoc=(2 + n,), free=1, nonneg=2 * m)

    def solver_factory(op_, rho_y_vec, rho_x_vec, Q_diag_s):
        """Row 0 touches only the s column (pure diagonal); rows 1..m
        carry the rank-(n+1) part."""
        H = rho_x_vec + (Q_diag_s if Q_diag_s is not None else 0.0)
        H_inv = 1.0 / H
        ht = H_inv / (Et * Et)
        Dr_t = Dt[1:]
        U_rows = (yt[:, None] * torch.cat(
            [Xt, torch.ones((m, 1), dtype=Xt.dtype, device=dev)], dim=1)
            ) / Dr_t[:, None]
        U_rows = U_rows * torch.sqrt(ht[2:3 + n])[None, :]
        U = torch.cat([torch.zeros((1, n + 1), dtype=Xt.dtype, device=dev),
                       U_rows], dim=0)
        Hu = torch.ones((n + 1,), dtype=Xt.dtype, device=dev)
        g0 = (ht[1] / (Dt[0] * Dt[0]))[None]
        g_rows = (ht[3 + n:3 + n + m] + ht[3 + n + m:]) / (Dr_t * Dr_t)
        return LowRankWoodburySolver(op_, H_inv, rho_y_vec, U, Hu,
                                     torch.cat([g0, g_rows]))

    return ConicProblem(A=op, b=b_s, c=c_s, cones=cones,
                        recover=_recover(X, y, C, m, n, 2, E * sc_b),
                        tol_ladder=SVM_PCG_LADDER,
                        solver_factory=solver_factory)


def solve_svm(X, y, C: float, form: str = "qp", settings=None,
              matrix_free: bool = False, device=None, **overrides):
    """One-call SVM solve on `device` (default: the CUDA card); returns
    (w, b0, objective, conic solution).  `form` selects the QP or SOCP
    embedding (the reference's `prob_type`, `mex/abip_ml_mex.c:90-146`);
    `matrix_free=True` applies the label-folded data on the fly with CG
    solves (both forms)."""
    from ..qcp import conic_defaults, solve_qcp

    if form not in ("qp", "socp"):
        raise ValueError(f"form must be 'qp' or 'socp'; got {form!r}")
    if matrix_free:
        build = svm_operator_qp if form == "qp" else svm_operator_socp
        prob = build(X, y, C, device=device)
        settings = settings or conic_defaults(normalize=False, linsys="cg")
    else:
        prob = (svm_to_conic_qp if form == "qp" else svm_to_conic_socp)(
            X, y, C)
    sol = solve_qcp(prob.A, prob.b, prob.c, prob.cones, Q=prob.Q,
                    settings=settings, tol_ladder=prob.tol_ladder,
                    solver_factory=prob.solver_factory, device=device,
                    **overrides)
    w, b0, obj = prob.recover(sol)
    return w, b0, obj, sol
