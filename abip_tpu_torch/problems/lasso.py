"""LASSO as a rotated-second-order-cone program.

    min_w  (1/2) ||X w - y||^2 + lam * ||w||_1

Port of `abip_tpu/problems/lasso.py` (the reference's embedding,
`source/lasso_config.c:8-93` and `mex/abip_ml_mex.c:320-330`, without
its hand-tuned scale constants: the equilibration replaces them):

    variables  z = (t1, t2, r in R^m, w+ in R^n, w- in R^n)
    cones      K = RSOC(2+m) x R+^{2n}
    rows       t1 = 1
               r + X (w+ - w-) = y          (so r = y - X w)
    objective  min  t2 + lam * 1'(w+ + w-)

RSOC gives 2 t1 t2 >= ||r||^2 with t1 = 1, i.e. t2 >= ||y - Xw||^2 / 2,
tight at the optimum; w = w+ - w- recovers the signed weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cones import ConeSpec
from ..device import resolve_device


@dataclasses.dataclass
class ConicProblem:
    A: object                 # (p, q) numpy array or a LinearOperator
    b: np.ndarray
    c: np.ndarray
    cones: ConeSpec
    recover: callable
    Q: np.ndarray | None = None
    # per-problem PCG tolerance ladder (k, error_ratio, norm_p) -> tol,
    # the role of `get_lasso_pcg_tol` / `get_svm_pcg_tol`
    tol_ladder: callable | None = None
    # custom KKT backend factory (op, rho_y_vec, rho_x_vec, Q_diag) ->
    # solver with `DenseSchurSolver.solve`'s signature on 1-D vectors:
    # the reference vtable's `init_spe_linsys_work`/`solve_spe_linsys`
    # (`include/abip.h:29-60`), used in place of the generic CG path
    solver_factory: callable | None = None
    # maps a solution of the scaled operator form to the units of the
    # embedding (`un_scaling_qcp_sol`, `qcp_config.c:496-513`); None
    # where the solve already returns them
    unscale: callable | None = None


def _recover(X, y, lam: float):
    """(w, objective) from a solution in the embedding's units:
    w = w+ - w-."""
    m, n = X.shape

    def recover(sol):
        z = np.asarray(sol.x)
        w = z[2 + m:2 + m + n] - z[2 + m + n:]
        obj = 0.5 * np.sum((X @ w - y) ** 2) + lam * np.sum(np.abs(w))
        return w, obj

    return recover


def lasso_to_conic(X, y, lam: float) -> ConicProblem:
    X = np.asarray(X, float)
    y = np.asarray(y, float)
    m, n = X.shape
    if y.shape != (m,):
        raise ValueError(f"y must have shape ({m},); got {y.shape}")
    if lam <= 0:
        raise ValueError("lam must be positive")

    q = 2 + m + 2 * n
    p = 1 + m
    A = np.zeros((p, q))
    A[0, 0] = 1.0                       # t1 = 1
    A[1:, 2:2 + m] = np.eye(m)          # r
    A[1:, 2 + m:2 + m + n] = X          # + X w+
    A[1:, 2 + m + n:] = -X              # - X w-
    b = np.concatenate([[1.0], y])
    c = np.zeros(q)
    c[1] = 1.0
    c[2 + m:] = lam

    cones = ConeSpec(rsoc=(2 + m,), nonneg=2 * n)
    return ConicProblem(A=A, b=b, c=c, cones=cones,
                        recover=_recover(X, y, lam))


def _lasso_products(operands):
    """(matvec, rmatvec) of A_s = D^-1 A E^-1, A = [[1,0,0,0,0],
    [0,0,I,X,-X]], over the operands X, D and E."""
    X, D, E = operands["X"], operands["D"], operands["E"]
    m, n = X.shape

    def matvec(z):
        z = z / E                       # undo the column scaling
        r = z[2:2 + m]
        w = z[2 + m:2 + m + n] - z[2 + m + n:]
        return torch.cat([z[:1], r + X @ w]) / D

    def rmatvec(u):
        u = u / D
        xt = X.T @ u[1:]
        return torch.cat([u[:1], torch.zeros_like(u[:1]), u[1:], xt,
                          -xt]) / E

    return matvec, rmatvec


def lasso_operator(X, y, lam: float, scaled: bool = True,
                   device=None) -> ConicProblem:
    """Matrix-free variant (`lasso_A_times`, `source/lasso_config.c:99-126`):
    the reformulated matrix is never formed; X is applied twice per
    product, as a tensor on `device` (default: the CUDA card).  The
    operator names its operands X, D and E (`LinearOperator.over`), so
    the Schur PCG's CUDA graphs rebuild it over their own buffers, and
    carries that PCG's iteration as two kernels (`pcg_iteration`,
    `ops.lasso_pcg.Iteration`).

    Layout: A z = [t1;  r + X w+ - X w-],  z = (t1, t2, r, w+, w-).

    `scaled=True` applies the analytic equilibration: the reformulated
    matrix's row and column norms follow from X in closed form (E tied
    over the RSOC block), with the b/c normalization of the dense
    pipeline.  The solve runs in scaled units (tolerances apply there,
    as in the reference's app configs); `unscale` maps a solution to
    the units of `lasso_to_conic`'s embedding, which `recover` reads."""
    from ..linsys.schur import LASSO_PCG_LADDER
    from ..ops.lasso_pcg import Iteration
    from ..problem import LinearOperator

    dev = resolve_device(device)
    Xnp = np.asarray(X, float)
    y = np.asarray(y, float)
    m, n = Xnp.shape
    q = 2 + m + 2 * n
    p = 1 + m

    # analytic row/col norms of A = [[1,0,0,0,0],[0,0,I,X,-X]]
    row_sq = np.concatenate([[1.0], 1.0 + 2.0 * np.sum(Xnp * Xnp, axis=1)])
    colX_sq = np.sum(Xnp * Xnp, axis=0)
    col_sq = np.concatenate([[1.0, 1.0], np.ones(m), colX_sq, colX_sq])
    if scaled:
        D = np.sqrt(np.sqrt(row_sq))            # origin-style sqrt norms
        E = np.sqrt(np.sqrt(np.maximum(col_sq, 1e-8)))
        # tie E over the RSOC block (t1, t2, r) like the conic pipeline
        E[:2 + m] = E[:2 + m].mean()
    else:
        D = np.ones(p)
        E = np.ones(q)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    op = LinearOperator.over(p, q, {"X": t(Xnp), "D": t(D), "E": t(E)},
                             _lasso_products,
                             nnz=2 * int(np.prod(Xnp.shape)) + m + 1)
    # the Schur PCG's iteration on these products as two kernels
    # (`linsys.schur._FusedPCGBlock`)
    op.pcg_iteration = Iteration
    # Jacobi diagonal of the Schur CG (`init_lasso_precon`,
    # `lasso_config.c:571-587`): the exact column norms of the scaled
    # matrix, from the block structure
    Xd_sq = np.sum((Xnp / D[1:, None]) ** 2, axis=0)
    exact_col_sq = np.concatenate(
        [[1.0 / D[0] ** 2, 0.0], 1.0 / D[1:] ** 2, Xd_sq, Xd_sq])
    op.col_norms_sq = exact_col_sq / (E * E)

    b = np.concatenate([[1.0], y])
    c = np.zeros(q)
    c[1] = 1.0
    c[2 + m:] = lam
    # b/c normalization (`scaling_qcp_data:462-485`)
    sc = float(np.sqrt(np.sqrt(b @ b + c @ c)))
    sc = 1.0 if sc < 1e-3 else min(sc, 1e3)
    sc_b = sc_c = 1.0 / sc
    b_s = b / D * sc_b
    c_s = c / E * sc_c
    cones = ConeSpec(rsoc=(2 + m,), nonneg=2 * n)

    def unscale(sol):
        # A_s = D^-1 A E^-1, b_s = sc_b D^-1 b, c_s = sc_c E^-1 c
        return dataclasses.replace(
            sol, x=np.asarray(sol.x) / (E * sc_b),
            y=np.asarray(sol.y) / (D * sc_c),
            s=np.asarray(sol.s) * E / sc_c,
            pobj=sol.pobj / (sc_b * sc_c), dobj=sol.dobj / (sc_b * sc_c))

    return ConicProblem(A=op, b=b_s, c=c_s, cones=cones,
                        recover=_recover(Xnp, y, lam),
                        tol_ladder=LASSO_PCG_LADDER, unscale=unscale)


def solve_lasso_batch(Xs, ys, lams, eps=1e-4, device=None, **kw):
    """Solve a sweep of same-shape LASSO instances as one batch
    (`test_lasso.m:36-120` runs one process per instance): the
    embeddings stacked through `solve_qcp_batch` (its default engine,
    "steps", unless `kw` names another) on `device` (default: the CUDA
    card).  Returns (W, objs, result)."""
    from ..parallel.batched_qcp import solve_qcp_batch

    Xs = np.asarray(Xs, float)
    ys = np.asarray(ys, float)
    lams = np.asarray(lams, float)
    B, m, n = Xs.shape
    probs = [lasso_to_conic(Xs[i], ys[i], float(lams[i])) for i in range(B)]
    res = solve_qcp_batch(np.stack([p.A for p in probs]),
                          np.stack([p.b for p in probs]),
                          np.stack([p.c for p in probs]),
                          cones=probs[0].cones, eps=eps, device=device, **kw)
    z = res.x.cpu().numpy()
    W = z[:, 2 + m:2 + m + n] - z[:, 2 + m + n:]
    objs = np.array([0.5 * np.sum((Xs[i] @ W[i] - ys[i]) ** 2)
                     + lams[i] * np.abs(W[i]).sum() for i in range(B)])
    return W, objs, res


def solve_lasso(X, y, lam: float, settings=None, matrix_free: bool = False,
                device=None, **overrides):
    """One-call LASSO solve on `device` (default: the CUDA card); returns
    (w, objective, conic solution), as the `abip_ml` front door
    (`mex/abip_ml_mex.c:90-146`).  `matrix_free=True` takes the operator
    form (X applied twice, the reformulated matrix never formed) with CG
    solves.  Either form returns the conic solution in the units of
    `lasso_to_conic`'s embedding.  The whole call, the embedding's build
    included, is one root span `qcp.solve`."""
    from ..qcp import ConicWorkspace, conic_defaults
    from ..utils.profiling import annotate

    settings = settings or (conic_defaults(normalize=False, linsys="cg")
                            if matrix_free else conic_defaults())
    if overrides:
        settings = dataclasses.replace(settings, **overrides)
    with annotate("qcp.solve") as root:
        with annotate("qcp.setup"):
            prob = (lasso_operator(X, y, lam, device=device) if matrix_free
                    else lasso_to_conic(X, y, lam))
        sol = ConicWorkspace(prob.A, prob.b, prob.c, prob.cones,
                             settings=settings, tol_ladder=prob.tol_ladder,
                             device=device).solve(root=root)
        if prob.unscale is not None:
            sol = prob.unscale(sol)
        w, obj = prob.recover(sol)
        return w, obj, sol
