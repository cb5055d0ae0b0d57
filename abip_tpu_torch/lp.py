"""ABIP linear programming driver on PyTorch: one LP, host-driven.

Port of `abip_tpu/lp.py`.  Solves  min c'x  s.t. Ax = b, x >= 0  by the
ADMM-based interior point method on the homogeneous self-dual (HSD)
embedding.  Iterates: u = (y, x, tau), v = (0, s, kappa), length
l = m + n + 1 (`abip.c:2076`, `include/abip.h:136-150` of the reference).

The reference runs the inner ADMM loop as one jitted `lax.while_loop`.
Here the loop runs on the host and issues each iteration's tensor ops to
the device: the counters j and k are Python ints, so the restart,
average and q-update cadences are host branches, and only the stop test
(`qres >= gamma*mu` and, with `final_check`, `status == 0`) is read back
from the device, once per iteration.  The iteration semantics are the
reference's: the same j, k, cadences and stop.

A scipy sparse A is packed as the compact rows of its stored entries
(the reference's BCSR layout) or as ELL rows
(`LinearOperator.from_scipy_sparse`); on a CUDA card every BCSR product
(projection, inner criterion, residuals, BB trials, PCG) launches the
kernel K5 (`csrc/bcsr_spmv.cu`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import hsd, schedules
from .device import ieee_f32 as _ieee_f32, resolve_device
from .hsd import LPResiduals as Residuals
from .linsys.cg import cg_tolerance, pcg
from .linsys.dense import cho_solve
from .linsys import make_solver  # noqa: F401  (public seam, as abip_tpu.lp)
from .problem import LinearOperator
from .scaling import ScalingData, equilibrate, equilibrate_sparse, normalize_bc
from .settings import Settings, Status

EPS_TOL = hsd.EPS_TOL
INDETERMINATE_TOL = 1e-9


class LPOperands(NamedTuple):
    """Problem data of one workspace; unused fields are None."""

    A: Optional[torch.Tensor]   # dense (m, n), or None for sparse kinds
    bcsr: object                # BCSRMatrix of A, or None
    bcsr_T: object              # BCSRMatrix of A', or None
    ell: object                 # ELLMatrix of A, or None (scattered sparsity)
    ell_T: object               # ELLMatrix of A', or None
    chol: Optional[torch.Tensor]  # (m, m) Cholesky factor, or None (cg)
    M: Optional[torch.Tensor]   # (m,) Jacobi preconditioner diag, or None
    h: torch.Tensor
    g: torch.Tensor
    g_th: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    pr_scale: torch.Tensor
    dr_scale: torch.Tensor
    obj_scale: torch.Tensor
    nm_b: torch.Tensor
    nm_c: torch.Tensor
    # row-sharded products (`parallel.sharded.row_sharded_operator`) of
    # a workspace distributed by `LPWorkspace.shard`; A is then this
    # rank's rows
    shard: Optional[LinearOperator] = None


def _ops_matvec(ops: LPOperands, x):
    if ops.shard is not None:
        return ops.shard.matvec(x)       # all_gather of the row blocks
    if ops.A is not None:
        return ops.A @ x
    if ops.ell is not None:
        from .ops.ell import ell_matvec

        return ell_matvec(ops.ell, x)
    from .ops.spmv import bcsr_matvec

    return bcsr_matvec(ops.bcsr, x)      # K5 on a CUDA card


def _ops_rmatvec(ops: LPOperands, y):
    if ops.shard is not None:
        return ops.shard.rmatvec(y)      # all_reduce of the partials
    if ops.A is not None:
        return ops.A.T @ y
    if ops.ell_T is not None:
        from .ops.ell import ell_matvec

        return ell_matvec(ops.ell_T, y)
    from .ops.spmv import bcsr_matvec

    return bcsr_matvec(ops.bcsr_T, y)    # K5 on a CUDA card


def _ops_solve(ops: LPOperands, stgs: Settings, w_y, w_x, k, warm):
    """KKT solve (dense-direct or PCG); returns (z_y, z_x, cg_iters)."""
    rhs = w_y + _ops_matvec(ops, w_x)
    if ops.chol is not None:
        z_y, its = cho_solve(ops.chol, rhs), 0
    else:
        tol = cg_tolerance(torch.linalg.vector_norm(rhs), k, stgs.cg_rate,
                           rhs.dtype)

        def G(y):
            return stgs.rho_y * y + _ops_matvec(ops, _ops_rmatvec(ops, y))

        x0 = warm if warm is not None else torch.zeros_like(w_y)
        z_y, its = pcg(G, ops.M, rhs, x0, tol, stgs.cg_max_iters)
    z_x = _ops_rmatvec(ops, z_y) - w_x
    return z_y, z_x, its


class InnerState(NamedTuple):
    """State of the inner ADMM loop: tensors on the device, counters on
    the host."""

    u: torch.Tensor
    v: torch.Tensor
    u_prev: torch.Tensor
    u_avg: torch.Tensor         # restart accumulator (`abip.c:587-630`)
    v_avg: torch.Tensor
    u_sum: torch.Tensor         # cumulative average (`abip.c:635-659`)
    v_sum: torch.Tensor
    u_avgcon: torch.Tensor
    v_avgcon: torch.Tensor
    j: int                      # inner iteration counter
    k: int                      # global ADMM iteration counter
    qres: torch.Tensor          # last inner-criterion value
    avg_criterion: torch.Tensor  # bool: averaged iterate is the candidate
    status: torch.Tensor        # int32 Status code, 0 while running
    res: Residuals
    cg_iters: int               # accumulated linsys aux iterations


def _dims(ops: LPOperands):
    return ops.b.shape[0], ops.c.shape[0]


def _solve_fn(ops, stgs):
    return lambda w_y, w_x, kk, warm: _ops_solve(ops, stgs, w_y, w_x, kk,
                                                 warm)


def _project_k(ops: LPOperands, u, v, k, *, stgs: Settings):
    m, n = _dims(ops)
    return hsd.project_lin_sys(u, v, ops.h, ops.g, ops.g_th, stgs.rho_y,
                               _solve_fn(ops, stgs), k, m, n)


def _calc_residuals_k(ops: LPOperands, u, v):
    """`calc_residuals` (`abip.c:458-535`) of one iterate."""
    m, n = _dims(ops)
    return hsd.lp_residuals(
        u, v, lambda x: _ops_matvec(ops, x), lambda y: _ops_rmatvec(ops, y),
        ops.b, ops.c, ops.pr_scale, ops.dr_scale, ops.obj_scale,
        ops.nm_b, ops.nm_c, m, n)


def _bb_beta_k(ops: LPOperands, u, v, mu, *, stgs: Settings):
    from .adaptive import bb_update_beta

    m, n = _dims(ops)
    return bb_update_beta(u, v, mu, ops.h, ops.g, ops.g_th, stgs.rho_y,
                          stgs.alpha, _solve_fn(ops, stgs), m, n,
                          stgs.adaptive_lookback, stgs.eps_cor, stgs.eps_pen)


def _running(s: InnerState, thresh) -> bool:
    """The inner loop's device-side stop test, `qres >= gamma*mu` and
    `status == 0`: the one host read of an iteration."""
    return bool((s.qres >= thresh) & (s.status == 0))


def _run_inner_k(ops: LPOperands, state: InnerState, mu, beta, gamma,
                 inner_stopper, final_check, ipm_i, max_iters, *,
                 stgs: Settings) -> InnerState:
    """The hot loop, `abip.c:2131-2215`.  mu, beta, gamma are 0-d tensors
    of the iterate's dtype; the other arguments are host values."""
    m, n = _dims(ops)
    solve_fn = _solve_fn(ops, stgs)
    lam = mu / beta
    thresh = gamma * mu
    fre = stgs.restart_fre
    P = stgs.qres_period

    def q_norm_resd(u, v):
        return hsd.q_norm_resd(u, v, lambda x: _ops_matvec(ops, x),
                               lambda y: _ops_rmatvec(ops, y), ops.b, ops.c,
                               m, n)

    s = state
    go = _running(s, thresh)
    while go and s.j < inner_stopper and s.k < max_iters:
        u_prev = s.u
        u_t, its = hsd.project_lin_sys(s.u, s.v, ops.h, ops.g, ops.g_th,
                                       stgs.rho_y, solve_fn, s.k, m, n)
        if stgs.half_update:
            u, v = hsd.admm_update_half(s.u, s.v, u_t, lam, m)
        else:
            u, v = hsd.admm_update(s.u, s.v, u_prev, u_t, lam, stgs.alpha, m)

        # restart (`abip.c:587-630`): accumulate, then average every
        # restart_fre iterations once past restart_thresh.
        u_avg = s.u_avg + u
        v_avg = s.v_avg + v
        if s.k >= stgs.restart_thresh and (s.j + 1) % fre == 0:
            u, v = u_avg / fre, v_avg / fre
            u_avg, v_avg = torch.zeros_like(u_avg), torch.zeros_like(v_avg)

        # cumulative average candidate (`abip.c:635-659`)
        u_sum = s.u_sum + u
        v_sum = s.v_sum + v
        dom = float(s.j + 1)
        u_avgcon = u_sum / dom
        v_avgcon = v_sum / dom

        # inner criterion (`abip.c:1951-2051`): every 10th iteration also
        # evaluate the averaged iterate and adopt it if better.  With
        # qres_period > 1 it runs only every P-th (and 10th) iteration and
        # stays stale in between.
        tenth = (s.j + 1) % 10 == 0
        fresh = P == 1 or (s.j + 1) % P == 0 or tenth
        if fresh:
            qres = q_norm_resd(u, v)
            avg_crit = torch.zeros_like(s.avg_criterion)
            if tenth:
                q_avg = q_norm_resd(u_avgcon, v_avgcon)
                avg_crit = q_avg < qres
                qres = torch.where(avg_crit, q_avg, qres)
        else:
            qres, avg_crit = s.qres, s.avg_criterion

        # convergence check (CONVERGED_INTERVAL=1) when final_check is on
        if final_check:
            res = _calc_residuals_k(ops, torch.where(avg_crit, u_avgcon, u),
                                    torch.where(avg_crit, v_avgcon, v))
            status = hsd.lp_converged_code(res, stgs.eps, stgs.pfeasopt,
                                           ipm_i > 0 and s.k > 0)
        else:
            res, status = s.res, torch.zeros_like(s.status)

        s = InnerState(
            u=u, v=v, u_prev=u_prev, u_avg=u_avg, v_avg=v_avg,
            u_sum=u_sum, v_sum=v_sum, u_avgcon=u_avgcon, v_avgcon=v_avgcon,
            j=s.j + 1, k=s.k + 1, qres=qres, avg_criterion=avg_crit,
            status=status, res=res, cg_iters=s.cg_iters + its)
        if fresh or final_check:
            go = _running(s, thresh)
    if stgs.half_update:
        # On a qres-triggered break only, lift strictly negative duals to
        # 1e-6 (`abip.c:2175-2185`); small positives and the y-block are
        # left untouched.
        qres_exit = (s.qres < thresh) & (s.status == 0)
        s = s._replace(v=torch.where(qres_exit & (s.v < 0),
                                     torch.full_like(s.v, 1e-6), s.v))
    return s


@dataclasses.dataclass
class LPSolution:
    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    status: int
    status_name: str
    pobj: float
    dobj: float
    res_pri: float
    res_dual: float
    rel_gap: float
    res_infeas: float
    res_unbdd: float
    ipm_iters: int
    admm_iters: int
    setup_time: float
    solve_time: float
    avg_cg_iters: float = 0.0


def _direct(stgs: Settings, m: int, n: int) -> bool:
    """Dense Cholesky of rho_y I + A A' when it is affordable, PCG
    otherwise (the reference's shape rule, `source/util.c:237-244`)."""
    return stgs.linsys == "dense" or (
        stgs.linsys == "auto" and m <= 4096 and float(m) * float(n) <= 5e7)


def _scales(scal, sc_b, sc_c, stgs, m, n, dtype, dev):
    """(pr_scale, dr_scale, obj_scale): the maps back to original units."""
    if not stgs.normalize:
        return (torch.ones((m,), dtype=dtype, device=dev),
                torch.ones((n,), dtype=dtype, device=dev),
                torch.ones((), dtype=dtype, device=dev))
    return (scal.D / (sc_b * stgs.scale), scal.E / (sc_c * stgs.scale),
            stgs.scale * sc_c * sc_b)


def _with_g(ops: LPOperands, stgs: Settings) -> LPOperands:
    """The HSD rank-1 data g = K^-1 h with its x-part negated, and
    g_th = h.g (`abip.c:1917-1924`)."""
    m = ops.b.shape[0]
    g_y, g_x, _ = _ops_solve(ops, stgs, ops.h[:m], ops.h[m:], -1, None)
    g = torch.cat([g_y, -g_x])
    return ops._replace(g=g, g_th=(ops.h * g).sum())


def _lp_dense_setup_shared(A, b, c, *, stgs):
    """Dense LP setup: equilibration, b/c normalization
    (`normalize.c:11-40`), the normal matrix + Cholesky
    (`direct.c:218-270`) or the Jacobi preconditioner, and the rank-1 HSD
    data.  Returns (scal, sc_b, sc_c, ops, nm_b, nm_c)."""
    dtype, dev = A.dtype, A.device
    m, n = A.shape
    nm_b = torch.linalg.vector_norm(b)
    nm_c = torch.linalg.vector_norm(c)
    if stgs.normalize:
        A_s, scal = equilibrate(A[None], stgs)
        A_s, scal = A_s[0], ScalingData(*(x[0] for x in scal))
        b_s, c_s, sc_b, sc_c = normalize_bc(scal, b, c, stgs.scale)
    else:
        A_s, b_s, c_s = A, b, c
        one = torch.ones((), dtype=dtype, device=dev)
        scal = ScalingData(D=torch.ones((m,), dtype=dtype, device=dev),
                           E=torch.ones((n,), dtype=dtype, device=dev),
                           mean_norm_row=one, mean_norm_col=one)
        sc_b = sc_c = one

    chol = M = None
    if _direct(stgs, m, n):
        N = stgs.rho_y * torch.eye(m, dtype=dtype, device=dev) + A_s @ A_s.T
        chol = torch.linalg.cholesky(N)
    else:
        M = 1.0 / (stgs.rho_y + (A_s * A_s).sum(dim=1))
    pr_scale, dr_scale, obj_scale = _scales(scal, sc_b, sc_c, stgs, m, n,
                                            dtype, dev)
    h = torch.cat([-b_s, c_s])
    ops = LPOperands(
        A=A_s, bcsr=None, bcsr_T=None, ell=None, ell_T=None, chol=chol, M=M,
        h=h, g=h, g_th=torch.zeros((), dtype=dtype, device=dev), b=b_s,
        c=c_s, pr_scale=pr_scale, dr_scale=dr_scale, obj_scale=obj_scale,
        nm_b=nm_b, nm_c=nm_c)
    return scal, sc_b, sc_c, _with_g(ops, stgs), nm_b, nm_c


def _floats(r: Residuals) -> dict:
    """The residual record as host floats, in one device read."""
    return dict(zip(Residuals._fields,
                    torch.stack([x.reshape(()) for x in r]).tolist()))


class LPWorkspace:
    """Setup-once state: scaled data, cached factorization, operators.

    Mirrors the `ABIP(init)` / `ABIP(solve)` split (`abip.c:2341-2422`)
    so a single factorization can serve repeated solves.  `device`
    defaults to the CUDA card (see `device.resolve_device`).
    """

    def __init__(self, A, b, c, settings: Settings = Settings(),
                 device=None):
        import scipy.sparse as sps

        settings = settings.resolved()
        settings.validate()
        t0 = time.perf_counter()
        self.stgs = settings
        self.device = dev = resolve_device(device)
        self.dtype = dtype = getattr(torch, settings.dtype)

        is_sparse = sps.issparse(A)
        if not is_sparse:
            A = torch.as_tensor(np.asarray(A) if not isinstance(
                A, torch.Tensor) else A).to(device=dev, dtype=dtype)
        b = torch.as_tensor(np.asarray(b) if not isinstance(
            b, torch.Tensor) else b).to(device=dev, dtype=dtype)
        c = torch.as_tensor(np.asarray(c) if not isinstance(
            c, torch.Tensor) else c).to(device=dev, dtype=dtype)
        if len(A.shape) != 2:
            raise ValueError(f"A must be 2-D; got shape {tuple(A.shape)}")
        m, n = A.shape
        if m <= 0 or n <= 0:
            raise ValueError(f"m and n must be positive; got m={m}, n={n}")
        if tuple(b.shape) != (m,):
            raise ValueError(
                f"b must have shape ({m},) to match A; got {tuple(b.shape)}")
        if tuple(c.shape) != (n,):
            raise ValueError(
                f"c must have shape ({n},) to match A; got {tuple(c.shape)}")
        # finite-data validation (`validate`, `abip.c:1646-1734`): NaN/inf
        # data otherwise propagates into a misleading Unbounded exit
        if not (bool(np.all(np.isfinite(A.data))) if is_sparse
                else bool(torch.isfinite(A).all())):
            raise ValueError("A contains NaN or infinite entries")
        if not bool(torch.isfinite(b).all()):
            raise ValueError("b contains NaN or infinite entries")
        if not bool(torch.isfinite(c).all()):
            raise ValueError("c contains NaN or infinite entries")
        self.m, self.n = m, n
        self.l = m + n + 1
        nnz = int(A.nnz) if is_sparse else int((A != 0).sum())
        self.sp = nnz / (m * n)

        with _ieee_f32():
            if is_sparse:
                ops = self._sparse_setup(A, b, c)
            else:
                (self.scal, self.sc_b, self.sc_c, ops,
                 self.nm_b, self.nm_c) = _lp_dense_setup_shared(
                    A, b, c, stgs=settings)
                self.A_op = LinearOperator.from_dense(ops.A, nnz=nnz)
        self.b, self.c = ops.b, ops.c
        self.linsys_kind = "dense" if ops.chol is not None else "cg"
        self.h, self.g, self.g_th = ops.h, ops.g, ops.g_th
        self.ops = ops
        self.setup_time = time.perf_counter() - t0

    def _sparse_setup(self, A, b, c) -> LPOperands:
        """Sparse setup: scipy equilibration, BCSR/ELL packing of A_s and
        A_s', and the host-assembled normal matrix (factored on the
        device) or the Jacobi preconditioner."""
        stgs, dtype, dev = self.stgs, self.dtype, self.device
        m, n = self.m, self.n
        # norms of the ORIGINAL data (used by certificates, `abip.c:1855`)
        self.nm_b = torch.linalg.vector_norm(b)
        self.nm_c = torch.linalg.vector_norm(c)
        if stgs.normalize:
            A_s, scal = equilibrate_sparse(A, stgs, device=dev)
            scal = ScalingData(*(x.to(dtype) for x in scal))
            b_s, c_s, sc_b, sc_c = normalize_bc(scal, b, c, stgs.scale)
        else:
            A_s, b_s, c_s = A, b, c
            one = torch.ones((), dtype=dtype, device=dev)
            scal = ScalingData(D=torch.ones((m,), dtype=dtype, device=dev),
                               E=torch.ones((n,), dtype=dtype, device=dev),
                               mean_norm_row=one, mean_norm_col=one)
            sc_b = sc_c = one
        self.scal, self.sc_b, self.sc_c = scal, sc_b, sc_c

        self.A_op = LinearOperator.from_scipy_sparse(A_s, dtype=dtype,
                                                     device=dev)
        chol = M = None
        if _direct(stgs, m, n):
            # normal matrix assembled host-side (the sparse-A analogue
            # of the one-time factorization, `direct.c:218-270`)
            N = (A_s @ A_s.T).toarray()
            N[np.diag_indices(m)] += stgs.rho_y
            chol = torch.linalg.cholesky(
                torch.as_tensor(N, dtype=dtype, device=dev))
        else:
            M = (1.0 / (stgs.rho_y + self.A_op.row_norms_sq)).to(dtype)
        pr_scale, dr_scale, obj_scale = _scales(scal, sc_b, sc_c, stgs, m, n,
                                                dtype, dev)
        ops = LPOperands(
            A=None, bcsr=getattr(self.A_op, "bcsr", None),
            bcsr_T=getattr(self.A_op, "bcsr_T", None),
            ell=getattr(self.A_op, "ell", None),
            ell_T=getattr(self.A_op, "ell_T", None), chol=chol, M=M,
            h=torch.cat([-b_s, c_s]), g=None,
            g_th=torch.zeros((), dtype=dtype, device=dev), b=b_s, c=c_s,
            pr_scale=pr_scale, dr_scale=dr_scale, obj_scale=obj_scale,
            nm_b=self.nm_b, nm_c=self.nm_c)
        return _with_g(ops, stgs)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def update_problem(self, b, c) -> "LPWorkspace":
        """Re-target this workspace at new b, c with the SAME A
        (`include/abip.h:116-123`): the cached factor and packed operators
        are reused; only the b/c-derived operands change (one extra KKT
        solve for the new rank-1 g)."""
        stgs = self.stgs
        m, n = self.m, self.n
        b = self._tensor(np.asarray(b) if not isinstance(b, torch.Tensor)
                         else b)
        c = self._tensor(np.asarray(c) if not isinstance(c, torch.Tensor)
                         else c)
        if tuple(b.shape) != (m,) or tuple(c.shape) != (n,):
            raise ValueError(f"b/c must have shapes ({m},)/({n},)")
        self.nm_b = torch.linalg.vector_norm(b)
        self.nm_c = torch.linalg.vector_norm(c)
        scal = self.scal
        if stgs.normalize:
            b_s, c_s, sc_b, sc_c = normalize_bc(scal, b, c, stgs.scale)
        else:
            b_s, c_s = b, c
            sc_b = sc_c = torch.ones((), dtype=self.dtype, device=self.device)
        self.sc_b, self.sc_c = sc_b, sc_c
        self.b, self.c = b_s, c_s
        pr_scale, dr_scale, obj_scale = _scales(scal, sc_b, sc_c, stgs, m, n,
                                                self.dtype, self.device)
        ops = self.ops._replace(b=b_s, c=c_s, pr_scale=pr_scale,
                                dr_scale=dr_scale, obj_scale=obj_scale,
                                nm_b=self.nm_b, nm_c=self.nm_c,
                                h=torch.cat([-b_s, c_s]))
        with _ieee_f32():
            self.ops = _with_g(ops, stgs)
        self.h, self.g, self.g_th = self.ops.h, self.ops.g, self.ops.g_th
        return self

    def shard(self, mesh, axis: str = "rows",
              linsys: str = "cg") -> "LPWorkspace":
        """Distribute this workspace over a device mesh: the whole ADMM
        loop then iterates distributed (`abip_tpu/lp.py:571-620`).

        `mesh` is the stand-in for the reference's JAX `Mesh`: a 1-D
        `torch.distributed.device_mesh.DeviceMesh` with axis `axis`, on
        the workspace's device type.  The call is SPMD: every rank of
        the mesh builds the same workspace from the same full data and
        calls `shard` and then `solve`, and every rank returns the whole
        solution.  Each rank keeps its block of rows of the scaled dense
        A; the two products with A become `all_gather(A_d x)` and
        `all_reduce(A_d' y_d)` (`parallel.sharded.row_sharded_operator`),
        the collectives GSPMD inserts for the reference.  The vectors of
        length m (y, b, pr_scale, the preconditioner) stay replicated, a
        layout choice, not a semantic one, so every other line of the
        loop runs unchanged and every rank holds bit-equal iterates.

        linsys="cg" (default): the KKT solve becomes PCG on
        rho_y I + AA', each product two collectives; a dense factor is
        dropped for the Jacobi diagonal 1/(rho_y + rowsum(A*A)).
        linsys="dense": keep the cached Cholesky factor, replicated;
        refused for a workspace built with linsys='cg'."""
        from .parallel.sharded import (check_rows, mesh_group,
                                       row_sharded_operator)

        group, rank, size = mesh_group(mesh, axis, self.device)
        check_rows(self.m, size)
        ops = self.ops
        if ops.A is None:
            raise ValueError(
                "shard() requires dense operands (BCSR/ELL sharding: use "
                "the batched suite path instead)")
        if linsys not in ("cg", "dense"):
            raise ValueError(f"linsys must be 'cg' or 'dense'; got {linsys!r}")
        if linsys == "dense" and ops.chol is None:
            raise ValueError("no cached factor: workspace was built with "
                             "linsys='cg'")
        repl = {}
        if linsys == "cg" and ops.chol is not None:
            # direct -> PCG: Jacobi diagonal of rho_y I + AA'
            # (`indirect.c:36-79`)
            repl = dict(chol=None, M=1.0 / (self.stgs.rho_y
                                            + (ops.A * ops.A).sum(dim=1)))
            self.linsys_kind = "cg"
        op = row_sharded_operator(ops.A, group, rank, size)
        op.nnz = self.A_op.nnz
        self.A_op = op
        self.ops = ops._replace(A=op.local, shard=op, **repl)
        return self

    # ------------------------------------------------------------------ #
    # host-side driver                                                   #
    # ------------------------------------------------------------------ #
    def project_lin_sys(self, u, v, k):
        return _project_k(self.ops, u, v, k, stgs=self.stgs)

    def _calc_residuals(self, u, v):
        return _calc_residuals_k(self.ops, u, v)

    def _cold_start(self, mu, beta):
        """`cold_start_vars` (`abip.c:361-381`)."""
        m, l = self.m, self.l
        val = np.sqrt(mu / beta)
        u = torch.cat([torch.zeros((m,), dtype=self.dtype, device=self.device),
                       torch.full((l - m,), val, dtype=self.dtype,
                                  device=self.device)])
        return u, u

    def _warm_start(self, warm, mu, beta):
        """Seed u, v from a caller-provided (x, y, s) in original units
        (`warm_start_vars` + `normalize_warm_start`, `abip.c:307-357`,
        `normalize.c:100-128`).  The reference's validation loop
        (`abip.c:326-349`) overwrites the whole warm start with the cold
        start, a fault not copied: the barrier coordinates are floored at
        sqrt(mu/beta)*1e-3 instead."""
        x, y, s = (np.asarray(a, float) for a in warm)
        m, n = self.m, self.n
        if x.shape != (n,) or y.shape != (m,) or s.shape != (n,):
            raise ValueError("warm start must be (x (n,), y (m,), s (n,))")
        D = self.scal.D.cpu().numpy()
        E = self.scal.E.cpu().numpy()
        sc_b, sc_c = float(self.sc_b), float(self.sc_c)
        x_s = x * (E * sc_b)
        y_s = y * (D * sc_c)
        s_s = s / (E / (sc_c * self.stgs.scale))
        floor = np.sqrt(mu / beta) * 1e-3
        u = self._tensor(np.concatenate([y_s, np.maximum(x_s, floor), [1.0]]))
        v = self._tensor(np.concatenate([np.zeros(m), np.maximum(s_s, floor),
                                         [floor]]))
        return u, v

    def _init_inner_state(self, u, v):
        z = torch.zeros((self.l,), dtype=self.dtype, device=self.device)
        return InnerState(
            u=u, v=v, u_prev=u, u_avg=z, v_avg=z, u_sum=z, v_sum=z,
            u_avgcon=u, v_avgcon=v, j=0, k=0,
            qres=torch.full((), torch.inf, dtype=self.dtype,
                            device=self.device),
            avg_criterion=torch.zeros((), dtype=torch.bool,
                                      device=self.device),
            status=torch.zeros((), dtype=torch.int32, device=self.device),
            res=Residuals.init((), self.dtype, self.device), cg_iters=0)

    def solve(self, warm=None, resume=None, checkpoint_path=None,
              checkpoint_every=0) -> LPSolution:
        """Run the outer IPM loop.

        warm: optional (x, y, s) seed in original units.
        resume: optional `SolverCheckpoint` to continue a prior solve.
        checkpoint_path/checkpoint_every: save state every k outer
        iterations (an .npz round-trip of the iterate).
        """
        with _ieee_f32():
            return self._solve(warm, resume, checkpoint_path,
                               checkpoint_every)

    def _solve(self, warm, resume, checkpoint_path, checkpoint_every):
        import signal

        from .utils import IterationLog, PhaseTimers, solver_banner
        from .utils.checkpoint import SolverCheckpoint

        stgs = self.stgs
        m, l = self.m, self.l
        t0 = time.perf_counter()
        log = IterationLog(enabled=stgs.verbose)
        timers = PhaseTimers(sync=torch.cuda.synchronize
                             if self.device.type == "cuda" else None)
        self._timers = timers
        if stgs.verbose:
            print(solver_banner("LP", m, self.n, self.A_op.nnz,
                                self.linsys_kind))

        # `update_work` (`abip.c:1843-1927`): sigma/gamma by sparsity
        sp_hi = max(self.sp, stgs.sparsity_ratio)
        sp_lo = min(self.sp, stgs.sparsity_ratio)
        if sp_hi > 0.4 or (0.1 < sp_lo < 0.2):
            sigma, gamma = 0.3, 2.0
        elif sp_lo > 0.2:
            sigma, gamma = 0.5, 3.0
        else:
            sigma, gamma = 0.8, 3.0

        mu, beta = 1.0, 1.0
        final_check = False
        double_check = False
        dynamic_sigma = stgs.dynamic_sigma

        i0 = 0
        if resume is not None:
            u, v = self._tensor(resume.u), self._tensor(resume.v)
            mu, beta = resume.mu, resume.beta
            sigma, gamma = resume.sigma, resume.gamma
            final_check = resume.final_check
            i0 = resume.ipm_iters
        elif warm is not None:
            u, v = self._warm_start(warm, mu, beta)
        else:
            u, v = self._cold_start(mu, beta)
        state = self._init_inner_state(u, v)
        if resume is not None:
            state = state._replace(k=int(resume.admm_iters))

        status = Status.UNFINISHED
        ipm_iter = i0
        admm_total = state.k
        res_np = None
        max_admm = stgs.max_admm_iters

        # SIGINT listener (`ctrlc.c:62-92`): ctrl-C sets a flag, the loop
        # exits at the next stage boundary and the current best iterate is
        # returned with status ABIP_SIGINT.
        interrupted = False

        def _on_sigint(signum, frame):
            nonlocal interrupted
            interrupted = True

        try:
            old_handler = signal.signal(signal.SIGINT, _on_sigint)
        except ValueError:          # not the main thread
            old_handler = None

        def active(st):
            if bool(st.avg_criterion):
                return st.u_avgcon, st.v_avgcon
            return st.u, st.v

        try:
            for i in range(i0, stgs.max_ipm_iters):
                ipm_iter = i
                if interrupted:
                    status = Status.SIGINT
                    break
                # inner_stopper by sparsity (`abip.c:2104-2115`)
                if sp_lo > 0.5:
                    inner_stopper = max(1, int(round(mu ** -0.35)))
                elif sp_lo > 0.2:
                    inner_stopper = max(1, int(round(mu ** -1.0)))
                else:
                    inner_stopper = max_admm

                # reset per-stage accumulators; adopt the averaged iterate
                # if selected
                u, v = active(state)
                z = torch.zeros((l,), dtype=self.dtype, device=self.device)
                state = state._replace(
                    u=u, v=v, u_avg=z, v_avg=z, u_sum=z, v_sum=z, j=0,
                    qres=torch.full((), torch.inf, dtype=self.dtype,
                                    device=self.device),
                    status=torch.zeros((), dtype=torch.int32,
                                       device=self.device))

                with timers.phase("inner_admm"):
                    state = _run_inner_k(
                        self.ops, state, self._tensor(mu), self._tensor(beta),
                        self._tensor(gamma), inner_stopper, final_check, i,
                        max_admm, stgs=stgs)
                admm_total = state.k
                inner_status = int(state.status)
                if inner_status != 0:
                    status = inner_status
                    res_np = _floats(state.res)
                    break

                # time limit (`abip.c:2217-2221`)
                if time.perf_counter() - t0 > stgs.max_time:
                    max_admm = int(admm_total * 1.05) + 1

                if mu < stgs.eps:
                    final_check = True

                # outer-loop residual check (`abip.c:2229-2248`)
                u_sel, v_sel = active(state)
                with timers.phase("residuals"):
                    r = self._calc_residuals(u_sel, v_sel)
                    res_np = _floats(r)
                state = state._replace(res=r)

                pobj = res_np["ct_x_by_tau"] / max(res_np["tau"], EPS_TOL)
                dobj = res_np["bt_y_by_tau"] / max(res_np["tau"], EPS_TOL)
                log.row(i, admm_total, mu, res_np, pobj, dobj)

                status = schedules.check_converged(res_np, stgs, i,
                                                   admm_total)
                if status != 0 or admm_total + 1 >= max_admm:
                    break

                # mu update (`abip.c:2251-2277`)
                mu, sigma, gamma, final_check, double_check, dynamic_sigma = (
                    schedules.update_mu(
                        mu, sigma, gamma, res_np, stgs, self.sp,
                        final_check, double_check, dynamic_sigma,
                        u=u_sel.cpu().numpy(), v=v_sel.cpu().numpy(), m=m))

                if (checkpoint_path and checkpoint_every
                        and (i + 1) % checkpoint_every == 0):
                    u_c, v_c = active(state)
                    SolverCheckpoint(
                        u=u_c.cpu().numpy(), v=v_c.cpu().numpy(), mu=mu,
                        beta=beta, sigma=sigma, gamma=gamma,
                        admm_iters=admm_total, ipm_iters=i + 1,
                        final_check=final_check).save(checkpoint_path)

                # reinitialize for next stage (`abip.c:996-1075`, indx=0)
                state = self._reinit(state, sigma)

                # adaptive penalty via BB spectral trials
                # (`abip.c:2281-2293`): sandwich the search between
                # sqrt(sigma) re-scalings (indx=1/2)
                if stgs.adaptive:
                    with timers.phase("adaptive_bb"):
                        state = self._reinit_scale(state, np.sqrt(sigma))
                        u_a, v_a = active(state)
                        beta = float(_bb_beta_k(self.ops, u_a, v_a,
                                                self._tensor(mu), stgs=stgs))
                        state = self._reinit_scale(state,
                                                   np.sqrt(1.0 / sigma))
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGINT, old_handler)
        if interrupted and status == Status.UNFINISHED:
            status = Status.SIGINT

        solve_time = time.perf_counter() - t0
        sol = self._extract_solution(state, res_np, status, ipm_iter,
                                     admm_total, solve_time)
        log.footer(sol.status_name, {
            "pobj": sol.pobj, "dobj": sol.dobj,
            "res_pri": sol.res_pri, "res_dual": sol.res_dual,
            "rel_gap": sol.rel_gap,
            "ipm_iters": sol.ipm_iters, "admm_iters": sol.admm_iters,
            "setup_time": sol.setup_time, "solve_time": sol.solve_time,
            "avg_cg_iters": sol.avg_cg_iters,
        }, timers)
        return sol

    def _reinit(self, state: InnerState, sigma):
        """`reinitialize_vars(w, 0)` on the active iterate."""
        sig = self._tensor(sigma)
        if bool(state.avg_criterion):
            u, v = hsd.reinit_rebalance(state.u_avgcon, state.v_avgcon, sig,
                                        self.m)
            return state._replace(u_avgcon=u, v_avgcon=v)
        u, v = hsd.reinit_rebalance(state.u, state.v, sig, self.m)
        return state._replace(u=u, v=v)

    def _reinit_scale(self, state: InnerState, factor):
        """`reinitialize_vars` modes 1/2 (`abip.c:1057-1072`): scale the
        barrier coordinates of the active iterate by `factor`."""
        m = self.m
        f = self._tensor(factor)

        def scl(u, v):
            return (torch.cat([u[:m], u[m:] * f]),
                    torch.cat([v[:m], v[m:] * f]))

        if bool(state.avg_criterion):
            u, v = scl(state.u_avgcon, state.v_avgcon)
            return state._replace(u_avgcon=u, v_avgcon=v)
        u, v = scl(state.u, state.v)
        return state._replace(u=u, v=v)

    def _extract_solution(self, state, res_np, status, ipm_iter, admm_total,
                          solve_time) -> LPSolution:
        """`get_solution` (`abip.c:1344-1414`) + un-normalization
        (`normalize.c:133-158`)."""
        m, n, l = self.m, self.n, self.l
        stgs = self.stgs
        avg = bool(state.avg_criterion)
        u_t = state.u_avgcon if avg else state.u
        v_t = state.v_avgcon if avg else state.v
        u, v = u_t.cpu().numpy(), v_t.cpu().numpy()
        if res_np is None:
            res_np = _floats(self._calc_residuals(u_t, v_t))

        x = u[m:m + n].copy()
        y = u[:m].copy()
        s = v[m:m + n].copy()
        tau = res_np["tau"]
        kap = res_np["kap"]
        bty = res_np["bt_y_by_tau"]
        ctx = res_np["ct_x_by_tau"]
        t = max(tau, EPS_TOL)

        if status == Status.UNFINISHED:
            if tau > INDETERMINATE_TOL and tau > kap:
                status = Status.SOLVED_INACCURATE
                x, y, s = x / t, y / t, s / t
            elif np.linalg.norm(u) < INDETERMINATE_TOL * np.sqrt(l):
                status = Status.INDETERMINATE
                x[:], y[:], s[:] = np.nan, np.nan, np.nan
            elif -bty < ctx:
                status = Status.INFEASIBLE_INACCURATE
                y, s = y / bty, s / bty
                x[:] = np.nan
            else:
                status = Status.UNBOUNDED_INACCURATE
                x = x / (-ctx)
                y[:], s[:] = np.nan, np.nan
        elif status in (Status.SIGINT, Status.SOLVED):
            # SIGINT: best-effort solution at interrupt time
            x, y, s = x / t, y / t, s / t
        elif status == Status.INFEASIBLE:
            y, s = y / bty, s / bty
            x[:] = np.nan
        elif status == Status.UNBOUNDED:
            x = x / (-ctx)
            y[:], s[:] = np.nan, np.nan

        if stgs.normalize:
            D = self.scal.D.cpu().numpy()
            E = self.scal.E.cpu().numpy()
            sc_b, sc_c = float(self.sc_b), float(self.sc_c)
            x = x / (E * sc_b)
            y = y / (D * sc_c)
            s = s * E / (sc_c * stgs.scale)

        solved_like = status in (Status.SOLVED, Status.SOLVED_INACCURATE,
                                 Status.SIGINT)
        pobj = ctx / tau if (solved_like and tau > EPS_TOL) else (
            -np.inf if status in (Status.UNBOUNDED,
                                  Status.UNBOUNDED_INACCURATE) else np.inf)
        dobj = bty / tau if (solved_like and tau > EPS_TOL) else pobj

        return LPSolution(
            x=x, y=y, s=s, status=int(status),
            status_name=Status.name(status),
            pobj=float(pobj), dobj=float(dobj),
            res_pri=res_np["res_pri"], res_dual=res_np["res_dual"],
            rel_gap=res_np["rel_gap"],
            res_infeas=res_np["res_infeas"], res_unbdd=res_np["res_unbdd"],
            ipm_iters=ipm_iter + 1, admm_iters=admm_total,
            setup_time=self.setup_time, solve_time=solve_time,
            avg_cg_iters=float(state.cg_iters) / max(1, admm_total))


def solve_lp(A, b, c, settings: Settings = Settings(), device=None,
             **overrides) -> LPSolution:
    """One-call LP solve: min c'x s.t. Ax = b, x >= 0 (the reference's
    `ABIP(main)`, `abip.c:2393-2422`).  A is a dense array or tensor or
    a scipy sparse matrix; the solve runs on the CUDA card unless
    `device` says otherwise."""
    if overrides:
        settings = dataclasses.replace(settings, **overrides)
    return LPWorkspace(A, b, c, settings, device=device).solve()
