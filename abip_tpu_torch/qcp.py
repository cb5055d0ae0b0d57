"""ABIP conic / quadratic cone programming driver on PyTorch: one problem,
host-driven.

Port of `abip_tpu/qcp.py`.  Solves

    min (1/2) x'Qx + c'x   s.t.  Ax = b,  x in K

with K a product of {zero, free, nonneg, SOC, RSOC} cones, by the
Douglas-Rachford inner loop of the reference conic core
(`src/abip-qcp/source/abip.c`): Schur-complement projection with the
quadratic-formula tau step, the cone barrier prox, the dual update, the
inner HSD-operator check and the cadenced residual checks; the outer
loop runs the barrier schedule (`adjust_barrier`, `abip.c:994-1071`).

The reference runs the inner loop as one jitted `lax.while_loop`.  Here
it is a host loop that issues each iteration's tensor ops to the device:
the counters j and k are Python ints, so the cadenced residual check is
a host branch, and one small packed tensor is read back per iteration
(the inner criterion, and where the check ran its status and error
ratio).  The stop and check decisions are the reference's.  The tensors
carry the lane axis of `conic_ops` at B=1.

LP is the special case Q=0, K=R+^n -- but the dedicated `lp.py` driver
keeps the reference's LP-specialized economies.

Spans (`utils.profiling`): `qcp.solve` roots a solve and notes its
`admm_iters` and `cg_iters`; under it `qcp.setup`, the `PhaseTimers`
phases `qcp.inner_admm` and `qcp.residuals`, `qcp.admm` (one iteration:
`qcp.project` with the Schur solve, `linsys.schur`'s `qcp.cg` and, where
its PCG runs as CUDA graphs, their `qcp.cg_block`s, `qcp.cone`,
`qcp.check`), `qcp.mu_update` and `qcp.extract`; every blocking read is
a `qcp.host_read`.
"""
from __future__ import annotations

import dataclasses
import signal
import time
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import conic_ops
from .cones import ConeLayout, ConeSpec, cone_operands
from .conic_ops import ConicResiduals
from .device import resolve_device
from .linsys.schur import CGSchurSolver, DenseSchurSolver
from .problem import LinearOperator
from .scaling import (MAX_SCALE, MIN_SCALE, ConicScalingData,
                      equilibrate_conic)
from .settings import Settings, Status
from .utils.checkpoint import ConicCheckpoint
from .utils.profiling import annotate, host_read

EPS_TOL = 1e-18


def conic_defaults(**overrides) -> Settings:
    """Conic defaults (`src/abip-qcp/source/util.c:203-255`): rho_y=1e-6."""
    base = dict(rho_y=1e-6, rho_x=1.0, rho_tau=1.0, psi=1.0,
                origin_rescale=True, pc_ruiz_rescale=True, qp_rescale=False)
    base.update(overrides)
    return Settings(**base)


class ConicInnerState(NamedTuple):
    """State of the inner DR loop: the iterate on the device, the
    counters and the decisions read back on the host."""

    u: torch.Tensor             # (1, l)
    v: torch.Tensor             # (1, l)
    v_origin: torch.Tensor      # (1, l)
    j: int                      # inner iteration counter
    k: int                      # global ADMM iteration counter
    err_inner: float            # last inner criterion
    status: int                 # code of the last residual check, 0 if none
    res: ConicResiduals         # last checked residuals, (1,) tensors
    error_ratio: float          # res.error_ratio, read back
    cg_iters: int               # accumulated linsys iterations


@dataclass
class ConicSolution:
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


def _floats(*tensors) -> list:
    """0-d or one-element tensors as host floats, in one device read."""
    packed = torch.stack([t.reshape(()).to(torch.float64) for t in tensors])
    with host_read():
        return packed.tolist()


def _as_tensor(x, dtype, dev):
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


class ConicWorkspace:
    """Setup-once conic workspace (`ABIP(init)`, `source/abip.c:1271-1311`).

    A is a dense array or tensor, or a matrix-free `LinearOperator`
    (`normalize=False`, `linsys="cg"`).  Q is None, a full (n, n) matrix
    or its diagonal (n,).  `solver_factory(A_op, rho_y, rho_x, Q)`
    builds a custom KKT backend for the CG path: a solver with the
    reference's `solve(w_y, w_x, iter_count, warm_start, tol_hint)` on
    1-D vectors (`linsys.schur.LowRankWoodburySolver`, for instance).
    `device` defaults to the CUDA card (see `device.resolve_device`).
    `linsys_iters` counts the iterations of every block solve the
    workspace made, the setup's included."""

    def __init__(self, A, b, c, cones: ConeSpec, Q=None,
                 settings: Optional[Settings] = None, tol_ladder=None,
                 solver_factory=None, device=None):
        self.linsys_iters = 0
        with annotate("qcp.setup"):
            self._setup(A, b, c, cones, Q, settings, tol_ladder,
                        solver_factory, device)

    def _setup(self, A, b, c, cones, Q, settings, tol_ladder, solver_factory,
               device):
        settings = (settings or conic_defaults()).resolved()
        settings.validate()
        t0 = time.perf_counter()
        self.stgs = settings
        self.device = dev = resolve_device(device)
        self.dtype = dtype = getattr(torch, settings.dtype)

        # A may be a dense array OR a matrix-free LinearOperator (the
        # reference's `spe_A_times` path, `lasso_config.c:99-126`)
        matrix_free = isinstance(A, LinearOperator)
        if matrix_free:
            if settings.normalize:
                raise ValueError(
                    "matrix-free operators require normalize=False (provide "
                    "pre-scaled data, as the reference app configs do)")
            if settings.linsys == "dense":
                raise ValueError("matrix-free operators require linsys='cg'")
            m, n = A.m, A.n
            self.A_op = A
            A_dense = None
        else:
            A_dense = _as_tensor(A, dtype, dev)
            m, n = A_dense.shape
        b = _as_tensor(b, dtype, dev)
        c = _as_tensor(c, dtype, dev)
        Q = _as_tensor(Q, dtype, dev) if Q is not None else None
        if tuple(b.shape) != (m,):
            raise ValueError(f"b must have shape ({m},); got {tuple(b.shape)}")
        if tuple(c.shape) != (n,):
            raise ValueError(f"c must have shape ({n},); got {tuple(c.shape)}")
        # finite-data validation (`validate`, `source/abip.c` init path):
        # NaN data otherwise hangs the inner loop
        if A_dense is not None and not bool(torch.isfinite(A_dense).all()):
            raise ValueError("A contains NaN or infinite entries")
        if not bool(torch.isfinite(b).all()):
            raise ValueError("b contains NaN or infinite entries")
        if not bool(torch.isfinite(c).all()):
            raise ValueError("c contains NaN or infinite entries")
        if Q is not None and not bool(torch.isfinite(Q).all()):
            raise ValueError("Q contains NaN or infinite entries")
        # Q: full (n, n) matrix or 1-D diagonal (the SVM-QP case,
        # `svm_qp_config.c:8-60`)
        Q_diag = None
        if Q is not None and Q.dim() == 1:
            if tuple(Q.shape) != (n,):
                raise ValueError(f"diagonal Q must have shape ({n},); got "
                                 f"{tuple(Q.shape)}")
            Q_diag, Q = Q, None
        elif Q is not None and tuple(Q.shape) != (n, n):
            raise ValueError(f"Q must have shape ({n},{n}); got "
                             f"{tuple(Q.shape)}")
        cones.validate_dim(n)
        self.m, self.n = m, n
        self.l = m + n + 1
        self.layout = ConeLayout(cones)
        self.co = cone_operands(cones, dev)   # once: no per-iteration copy
        self.has_Q = Q is not None or Q_diag is not None

        use_cg = (matrix_free or settings.linsys == "cg"
                  or (settings.linsys == "auto" and n > 4096))
        if (not use_cg and settings.dense_mode == "inverse_mixed"
                and settings.rho_y < 1e-4 and n >= 500):
            # inverse_mixed at conic defaults (rho_y=1e-6) stalled a
            # dim-1020 instance for 85k iterations in the reference:
            # cond(S) ~ 1/rho_y exceeds what the mode's 3 refinement steps
            # against the f32 inverse can recover at this size
            warnings.warn(
                "dense_mode='inverse_mixed' with rho_y < 1e-4 on a "
                f"dim-{n} system may stall (cond(S) ~ "
                f"{1 / settings.rho_y:.0e} exceeds the f32-inverse IR "
                "budget); prefer dense_mode='chol' or rho_y >= 1e-3",
                stacklevel=2)

        # inf-norms of the ORIGINAL data (`init_work`, `abip.c:873-874`)
        self.nm_inf_b = self._inf_norm(b)
        self.nm_inf_c = self._inf_norm(c)
        if settings.normalize:
            # a diagonal Q rides the equilibration directly so E sees its
            # magnitudes (`qcp_config.c:239-248`)
            q_arg = Q if Q is not None else Q_diag
            A2, q_out, b2, c2, scal = equilibrate_conic(
                A_dense[None], None if q_arg is None else q_arg[None],
                b[None], c[None], self.layout, settings)
            A_dense, b, c = A2[0], b2[0], c2[0]
            if Q is not None:
                Q = q_out[0]
            elif Q_diag is not None:
                Q_diag = q_out[0]
        else:
            one = torch.ones((1,), dtype=dtype, device=dev)
            scal = ConicScalingData(
                D=torch.ones((1, m), dtype=dtype, device=dev),
                E=torch.ones((1, n), dtype=dtype, device=dev),
                sc_b=one, sc_c=one)
        self.scal = scal
        self.Q, self.Q_diag = Q, Q_diag
        self.b, self.c = b[None], c[None]
        if not matrix_free:
            self.A = A_dense
            self.A_op = LinearOperator.from_dense(A_dense)
        else:
            self.A = None

        # DR scaling rho_dr = (rho_y 1_m, rho_x 1_n, rho_tau)
        # (`init_qcp`, `qcp_config.c:26-36`)
        self.rho = torch.cat([
            torch.full((m,), settings.rho_y, dtype=dtype, device=dev),
            torch.full((n,), settings.rho_x, dtype=dtype, device=dev),
            torch.full((1,), settings.rho_tau, dtype=dtype, device=dev)])
        self.rho_tail = self.rho[m:]
        ry, rx = self.rho[:m], self.rho[m:m + n]
        if not use_cg:
            # a 1-D Q_diag keeps DenseSchurSolver's Woodbury (m x m) form
            # open; a full Q takes the primal (n x n) form
            self.solver = DenseSchurSolver(
                A_dense[None],
                Q[None] if Q is not None else
                (Q_diag[None] if Q_diag is not None else None),
                ry, rx, mode=settings.dense_mode)
        elif solver_factory is not None:
            # per-problem custom KKT backend (the `spe_problem` vtable's
            # init_spe_linsys_work/solve_spe_linsys seam,
            # `include/abip.h:29-60`)
            self.solver = solver_factory(self.A_op, ry, rx,
                                         Q_diag if Q is None else Q)
        else:
            # Jacobi preconditioner diag(S) (`init_qcp_precon`,
            # `qcp_config.c:754-780`); matrix-free operators may supply
            # their column norms (`col_norms_sq`)
            if matrix_free:
                col_sq = getattr(self.A_op, "col_norms_sq", None)
                diag_S = rx + (_as_tensor(col_sq, dtype, dev) / settings.rho_y
                               if col_sq is not None else
                               torch.zeros((n,), dtype=dtype, device=dev))
            else:
                diag_S = rx + (A_dense * A_dense / ry[:, None]).sum(0)
            if Q is not None:
                diag_S = diag_S + torch.diagonal(Q)
            elif Q_diag is not None:
                diag_S = diag_S + Q_diag
            Q_op = None
            if Q is not None:
                Q_op = lambda x: Q @ x  # noqa: E731
            elif Q_diag is not None:
                Q_op = lambda x: Q_diag * x  # noqa: E731
            self.solver = CGSchurSolver(self.A_op, Q_op, ry, rx, diag_S,
                                        max_iters=settings.cg_max_iters,
                                        tol_ladder=tol_ladder)
        self._set_rhs_terms()
        self.setup_time = time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    @staticmethod
    def _inf_norm(x):
        return (torch.abs(x).amax()[None] if x.numel()
                else torch.zeros((1,), dtype=x.dtype, device=x.device))

    def _set_rhs_terms(self):
        """r = Ktilde^-1 (-b; c), a = rho_tau + <rho . r, r>
        (`pre_calculate`, `source/abip.c:886-910`)."""
        m, n = self.m, self.n
        r_y, r_x, _ = self._solve(-self.b, self.c, -1, None)
        self.r_vec = torch.cat([r_y, r_x], dim=1)
        self.a_coef = self.stgs.rho_tau + (
            self.rho[:m + n] * self.r_vec * self.r_vec).sum(-1)

    def _solve(self, w_y, w_x, k, warm, err=None):
        """The block solve on `(1, m)`, `(1, n)` rhs: the dense solver
        takes the lane axis, the others (CG, custom) 1-D vectors."""
        if isinstance(self.solver, DenseSchurSolver):
            return self.solver.solve(w_y, w_x, iter_count=k,
                                     warm_start=warm, tol_hint=err)
        z_y, z_x, its = self.solver.solve(
            w_y[0], w_x[0], iter_count=k,
            warm_start=None if warm is None else warm[0], tol_hint=err)
        its = its if isinstance(its, int) else int(its)
        self.linsys_iters += its
        return z_y[None], z_x[None], its

    def _matvec(self, x):
        return self.A_op.matvec(x[0])[None]

    def _rmatvec(self, y):
        return self.A_op.rmatvec(y[0])[None]

    def _Q_times(self, x):
        if self.Q is not None:
            return (self.Q @ x[0])[None]
        if self.Q_diag is not None:
            return self.Q_diag * x
        return torch.zeros_like(x)

    def _calc_residuals(self, u, v_origin, prev: ConicResiduals):
        """`calc_qcp_residuals` (`qcp_config.c:562-691`)."""
        stgs, sc = self.stgs, self.scal
        return conic_ops.conic_residuals(
            u, v_origin, prev, self._matvec, self._rmatvec, self._Q_times,
            self.b, self.c, sc.D, sc.E, sc.sc_b, sc.sc_c,
            stgs.scale if stgs.normalize else 1.0, self.nm_inf_b,
            self.nm_inf_c, stgs.eps_p, stgs.eps_d, stgs.eps_g, self.m,
            self.n)

    def _has_converged(self, r: ConicResiduals, total_pos: bool):
        """`has_converged` (`source/abip.c:750-777`), a `(1,)` code."""
        stgs = self.stgs
        return conic_ops.conic_converged_code(
            r, stgs.eps_p, stgs.eps_d, stgs.eps_g, stgs.eps_inf,
            stgs.eps_unb, stgs.err_dif, total_pos)

    def _iterate(self, s: ConicInnerState, lam, ipm_i) -> ConicInnerState:
        """One DR iteration (`abip_tpu/qcp.py:138-165`): projection,
        barrier prox and dual update, inner criterion, and every
        inner_check_period-th iteration (or once the error ratio is at
        most 8) the residual check; then the one read-back."""
        stgs = self.stgs
        m, n = self.m, self.n
        with annotate("qcp.project"):
            u_t, its = conic_ops.projection(
                s.u, s.v, self._solve, self.rho, self.r_vec, self.a_coef,
                self._Q_times, m, n, s.k, err_ratio=s.error_ratio)
        with annotate("qcp.cone"):
            u, v = conic_ops.barrier_and_dual(s.u, s.v, u_t, lam,
                                              self.rho_tail, self.layout,
                                              stgs.alpha, m, n, self.co)
        v_origin = self.rho * v
        k = s.k + 1
        err = conic_ops.inner_conv_check(u, v_origin, self._matvec,
                                         self._rmatvec, self._Q_times,
                                         self.b, self.c, m, n)
        # cadenced residual check (`source/abip.c:1170-1207`)
        if (s.j + 1) % stgs.inner_check_period == 0 or s.error_ratio <= 8.0:
            with annotate("qcp.check"):
                res = self._calc_residuals(u, v_origin, s.res)
                st = self._has_converged(res, ipm_i > 0 and k > 0)
                err_h, st_h, ratio = _floats(err, st, res.error_ratio)
        else:
            res, st_h, ratio = s.res, 0, s.error_ratio
            with host_read():
                err_h = err.item()
        return ConicInnerState(u=u, v=v, v_origin=v_origin, j=s.j + 1, k=k,
                               err_inner=err_h, status=int(st_h), res=res,
                               error_ratio=ratio, cg_iters=s.cg_iters + its)

    def _run_inner(self, s: ConicInnerState, lam, tol_inner, ipm_i, k_cap,
                   j_cap) -> ConicInnerState:
        """One sprint of a barrier stage: iterate while j < j_cap, the
        inner criterion is at least tol_inner, no check has ended the
        solve and k < k_cap (`abip_tpu/qcp.py:167-184`)."""
        while (s.j < j_cap and s.err_inner >= tol_inner and s.status == 0
               and s.k < k_cap):
            with annotate("qcp.admm"):
                s = self._iterate(s, lam, ipm_i)
        return s

    # ------------------------------------------------------------------ #
    def _adjust_barrier(self, mu, res_np):
        """`adjust_barrier` (`source/abip.c:994-1071`) via the shared
        bucket tables (`conic_ops.adjust_barrier_device`), on the host's
        copies."""
        stgs = self.stgs
        eps_min = min(stgs.eps_p, stgs.eps_d, stgs.eps_g)
        f64 = torch.float64
        mu_new, tol = conic_ops.adjust_barrier_device(
            torch.tensor([mu], dtype=f64),
            torch.tensor([res_np["error_ratio"]], dtype=f64), eps_min,
            stgs.psi)
        return float(mu_new[0]), float(tol[0])

    def update_problem(self, b, c) -> "ConicWorkspace":
        """Re-target this workspace at new b, c with the SAME A, Q, cones
        (`abip_tpu/qcp.py:516-553`).  The cached Schur factor or
        preconditioner is reused; only the b/c-derived quantities (scaled
        b, c, r_vec, a_coef, inf-norms) are recomputed -- one extra
        linsys solve."""
        stgs, dtype, dev = self.stgs, self.dtype, self.device
        m, n = self.m, self.n
        b = _as_tensor(b, dtype, dev)
        c = _as_tensor(c, dtype, dev)
        if tuple(b.shape) != (m,) or tuple(c.shape) != (n,):
            raise ValueError(f"b/c must have shapes ({m},)/({n},)")
        self.nm_inf_b = self._inf_norm(b)
        self.nm_inf_c = self._inf_norm(c)
        if stgs.normalize:
            # sc from the new un-equilibrated b, c (`qcp_config.c:462-463`)
            sc = torch.sqrt(torch.sqrt((c * c).sum() + (b * b).sum()))
            sc = torch.where(sc < MIN_SCALE, torch.ones_like(sc),
                             torch.clamp(sc, max=MAX_SCALE))[None]
            sc_b = 1.0 / sc
            sc_c = 1.0 / sc
            b = b / self.scal.D[0] * (sc_b * stgs.scale)
            c = c / self.scal.E[0] * (sc_c * stgs.scale)
            self.scal = self.scal._replace(sc_b=sc_b, sc_c=sc_c)
        self.b, self.c = b[None], c[None]
        self._set_rhs_terms()
        return self

    def shard(self, mesh, axis: str = "rows") -> "ConicWorkspace":
        """Distribute this conic workspace over a device mesh: the whole
        DR/ADMM loop then iterates distributed (`abip_tpu/qcp.py:555-589`,
        the conic counterpart of `LPWorkspace.shard`).

        `mesh` is the stand-in for the reference's JAX `Mesh`: a 1-D
        `torch.distributed.device_mesh.DeviceMesh` with axis `axis`, on
        the workspace's device type.  The call is SPMD: every rank builds
        the same workspace from the same full data and calls `shard` and
        then `solve`, and every rank returns the whole solution.

        Requires the matrix-free CG Schur path (`linsys='cg'`) with a
        dense A, m divisible by the mesh size.  The row-sharded operator
        (`parallel.sharded.row_sharded_operator`: A x all-gathered, A' y
        all-reduced) serves the loop and the CG Schur solver.  ry_inv and
        b stay replicated."""
        from .parallel.sharded import (check_rows, mesh_group,
                                       row_sharded_operator)

        group, rank, size = mesh_group(mesh, axis, self.device)
        if not isinstance(self.solver, CGSchurSolver):
            raise ValueError(
                "shard() requires the CG Schur path; rebuild the "
                "workspace with settings.linsys='cg'")
        if self.A is None:
            raise ValueError(
                "shard() requires a dense A (matrix-free operators carry "
                "their own distribution)")
        check_rows(self.m, size)
        self.A_op = row_sharded_operator(self.A, group, rank, size)
        self.solver.A_op = self.A_op
        return self

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)[None]

    def _warm_start(self, warm, mu, beta):
        """Seed u, v from caller-provided (x, y, s) in original units,
        cone-interiorized (see `ConeLayout.interiorize`)."""
        x, y, s = (np.asarray(a, float) for a in warm)
        m, n = self.m, self.n
        if x.shape != (n,) or y.shape != (m,) or s.shape != (n,):
            raise ValueError("warm start must be (x (n,), y (m,), s (n,))")
        with host_read():
            D = self.scal.D[0].cpu().numpy()
            E = self.scal.E[0].cpu().numpy()
        sc_b, sc_c = _floats(self.scal.sc_b, self.scal.sc_c)
        # invert the un-scaling of `_extract_solution`
        x_s = x * (E * sc_b)
        y_s = y * (D * sc_c)
        s_s = s * (sc_c * self.stgs.scale) / E
        floor = float(np.sqrt(mu / beta) * 1e-3)
        u = self._tensor(np.concatenate(
            [y_s, self.layout.interiorize(x_s, floor), [1.0]]))
        v = self._tensor(np.concatenate(
            [np.zeros(m), self.layout.interiorize(s_s, floor, dual=True),
             [floor]]))
        return u, v

    def solve(self, warm=None, resume=None, checkpoint_path=None,
              checkpoint_every=0, root=None) -> ConicSolution:
        """Run the solver.

        warm: optional (x, y, s) in original units to seed the iterate.
        resume: optional `ConicCheckpoint` to continue a prior solve.
        checkpoint_path/checkpoint_every: save state every k outer
        iterations (plus once at exit) to `checkpoint_path`.
        root: the open root span `qcp.solve` of a caller that built this
        workspace under it (`solve_qcp`, `problems.solve_lasso`); without
        one the solve opens its own.  The root notes the solve's ADMM
        iterations (`admm_iters`) and the iterations of the block solves
        made under it (`cg_iters`: the setup's too, where the workspace
        was built under it).
        """
        if root is not None:
            return self._run(root, 0, warm, resume, checkpoint_path,
                             checkpoint_every)
        with annotate("qcp.solve") as span:
            return self._run(span, self.linsys_iters, warm, resume,
                             checkpoint_path, checkpoint_every)

    def _run(self, root, linsys0, warm, resume, checkpoint_path,
             checkpoint_every) -> ConicSolution:
        from .utils import IterationLog, PhaseTimers, solver_banner

        stgs = self.stgs
        m, n = self.m, self.n
        dtype, dev = self.dtype, self.device
        t0 = time.perf_counter()
        log = IterationLog(enabled=stgs.verbose)
        timers = PhaseTimers.of_solve(stgs.verbose, dev, "qcp")
        if stgs.verbose:
            nnz = (int((self.A != 0).sum()) if self.A is not None
                   else self.A_op.nnz)
            print(solver_banner("conic", m, n, nnz,
                                type(self.solver).__name__))

        mu, beta = 1.0, 1.0
        tol_inner = 4.0 * mu ** stgs.psi
        i0 = k0 = 0
        if resume is not None:
            u, v = self._tensor(resume.u), self._tensor(resume.v)
            mu, tol_inner = resume.mu, resume.tol_inner
            i0, k0 = resume.ipm_iters, int(resume.admm_iters)
        elif warm is not None:
            u, v = self._warm_start(warm, mu, beta)
        else:
            # cone-aware cold start (`update_work`, `source/abip.c:912-992`)
            x0 = self.layout.interior_point(dtype, dev)
            u = torch.cat([torch.zeros((m,), dtype=dtype, device=dev), x0,
                           torch.ones((1,), dtype=dtype, device=dev)])[None]
            v = u
        state = ConicInnerState(
            u=u, v=v, v_origin=self.rho * v, j=0, k=k0,
            err_inner=float("inf"), status=0,
            res=ConicResiduals.init(1, dtype, dev), error_ratio=1e8,
            cg_iters=0)
        k_cap = stgs.max_admm_iters * stgs.max_ipm_iters
        status = Status.UNFINISHED
        ipm_iter = i0
        res_np = None
        # sprint length: SIGINT/max_time response granularity
        chunk = max(1, stgs.inner_check_period) * 10

        # SIGINT listener (`ctrlc.c:62-92` pattern, shared with the LP
        # driver): ctrl-C sets a flag, checked between sprints
        interrupted = False

        def _on_sigint(signum, frame):
            nonlocal interrupted
            interrupted = True

        try:
            old_handler = signal.signal(signal.SIGINT, _on_sigint)
        except ValueError:          # not the main thread
            old_handler = None

        timed_out = False
        try:
            for i in range(i0, stgs.max_ipm_iters):
                ipm_iter = i
                if interrupted:
                    status = Status.SIGINT
                    break
                state = state._replace(j=0, err_inner=float("inf"), status=0)
                # one barrier stage = several bounded sprints, so SIGINT
                # and max_time stay responsive inside long stages
                while True:
                    j_cap = min(stgs.max_admm_iters, state.j + chunk)
                    with timers.phase("inner_admm"):
                        state = self._run_inner(state, mu / beta, tol_inner,
                                                i, k_cap, j_cap)
                    timed_out = time.perf_counter() - t0 > stgs.max_time
                    if (interrupted or timed_out
                            or state.err_inner < tol_inner
                            or state.status != 0
                            or state.j >= stgs.max_admm_iters
                            or state.k >= k_cap):
                        break
                if interrupted:
                    status = Status.SIGINT
                    break
                if state.status != 0:
                    status = state.status
                    res_np = dict(zip(ConicResiduals._fields,
                                      _floats(*state.res)))
                    break

                # outer residual check (`source/abip.c:1212-1243`)
                with timers.phase("residuals"):
                    r = self._calc_residuals(state.u, state.v_origin,
                                             state.res)
                    st = self._has_converged(r, i > 0 and state.k > 0)
                    vals = _floats(*r, st)
                res_np = dict(zip(ConicResiduals._fields, vals[:-1]))
                state = state._replace(res=r,
                                       error_ratio=res_np["error_ratio"])
                log.row(i, state.k, mu, res_np, res_np["pobj"],
                        res_np["dobj"])
                status = int(vals[-1])
                if status != 0 or state.k + 1 >= k_cap or timed_out:
                    break

                with annotate("qcp.mu_update"):
                    mu, tol_inner = self._adjust_barrier(mu, res_np)
                if checkpoint_path and checkpoint_every and \
                        (i + 1) % checkpoint_every == 0:
                    self._checkpoint(state, mu, tol_inner,
                                     i + 1).save(checkpoint_path)
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGINT, old_handler)
        if interrupted and status == Status.UNFINISHED:
            status = Status.SIGINT
        if checkpoint_path:
            self._checkpoint(state, mu, tol_inner,
                             ipm_iter + 1).save(checkpoint_path)

        with annotate("qcp.extract"):
            sol = self._extract_solution(state, res_np, status, ipm_iter, t0,
                                         k0)
        root.note(admm_iters=sol.admm_iters,
                  cg_iters=self.linsys_iters - linsys0)
        log.footer(sol.status_name, {
            "pobj": sol.pobj, "dobj": sol.dobj,
            "res_pri": sol.res_pri, "res_dual": sol.res_dual,
            "rel_gap": sol.rel_gap,
            "ipm_iters": sol.ipm_iters, "admm_iters": sol.admm_iters,
            "setup_time": sol.setup_time, "solve_time": sol.solve_time,
            "avg_cg_iters": sol.avg_cg_iters,
        }, timers)
        return sol

    @staticmethod
    def _checkpoint(state, mu, tol_inner, ipm_iters):
        with host_read():
            u, v = state.u[0].cpu().numpy(), state.v[0].cpu().numpy()
        return ConicCheckpoint(u=u, v=v, mu=mu, tol_inner=tol_inner,
                               admm_iters=state.k, ipm_iters=ipm_iters)

    def _extract_solution(self, state, res_np, status, ipm_iter, t0, k0):
        """`get_solution` (`source/abip.c:559-587`) + un-scaling
        (`un_scaling_qcp_sol`, `qcp_config.c:496-513`).  `avg_cg_iters`
        divides the linsys iterations of this run by the ADMM iterations
        of this run (k - k0 on a resumed solve; the reference divides by
        the cumulative k, `abip_tpu/qcp.py:838`)."""
        m, n = self.m, self.n
        stgs = self.stgs
        with host_read():
            u = state.u[0].cpu().numpy()
            v = state.v[0].cpu().numpy()
        if res_np is None:
            res_np = dict(zip(ConicResiduals._fields, _floats(
                *self._calc_residuals(state.u, state.v_origin, state.res))))
        tau = max(res_np["tau"], EPS_TOL)

        x = u[m:m + n].copy()
        y = u[:m].copy()
        s = v[m:m + n].copy()

        if status in (Status.INFEASIBLE, Status.INFEASIBLE_INACCURATE):
            bty = res_np["dobj"] * res_np["tau"]
            y, s = y / bty, s / bty
            x[:] = np.nan
        elif status in (Status.UNBOUNDED, Status.UNBOUNDED_INACCURATE):
            ctx = res_np["pobj"] * res_np["tau"]
            x = x / (-ctx)
            y[:], s[:] = np.nan, np.nan
        else:
            if status == Status.UNFINISHED:
                status = Status.SOLVED_INACCURATE
            x, y, s = x / tau, y / tau, s / tau

        if stgs.normalize:
            with host_read():
                D = self.scal.D[0].cpu().numpy()
                E = self.scal.E[0].cpu().numpy()
            sc_b, sc_c = _floats(self.scal.sc_b, self.scal.sc_c)
            x = x / (E * sc_b)
            y = y / (D * sc_c)
            s = s * E / (sc_c * stgs.scale)

        return ConicSolution(
            x=x, y=y, s=s,
            status=int(status), status_name=Status.name(status),
            pobj=res_np["pobj"], dobj=res_np["dobj"],
            res_pri=res_np["res_pri"], res_dual=res_np["res_dual"],
            rel_gap=res_np["rel_gap"],
            res_infeas=res_np["res_infeas"], res_unbdd=res_np["res_unbdd"],
            ipm_iters=ipm_iter + 1, admm_iters=state.k,
            setup_time=self.setup_time,
            solve_time=time.perf_counter() - t0,
            avg_cg_iters=state.cg_iters / max(1, state.k - k0),
        )


def solve_qcp(A, b, c, cones: ConeSpec, Q=None,
              settings: Optional[Settings] = None, tol_ladder=None,
              solver_factory=None, device=None, **overrides) -> ConicSolution:
    """One-call conic solve (`abip()`, `source/abip.c:1335-1371`); runs
    on the CUDA card unless `device` says otherwise.  The workspace's
    setup and its solve share one root span `qcp.solve`."""
    settings = settings or conic_defaults()
    if overrides:
        settings = dataclasses.replace(settings, **overrides)
    with annotate("qcp.solve") as root:
        w = ConicWorkspace(A, b, c, cones, Q=Q, settings=settings,
                           tol_ladder=tol_ladder,
                           solver_factory=solver_factory, device=device)
        return w.solve(root=root)
