"""Presolve: general-form LP -> ABIP standard form  min c'x, Ax=b, x>=0.

Port of `abip_tpu/io/presolve.py`; the presolve itself is the
reference's numpy/scipy code, copied.

Re-derivation of the reference presolve (`scripts/bench-lp/preprocess.m:22-77`):

  * shift variables by their lower bounds (x' = x - lb >= 0); free /
    unbounded-below variables are split x = x+ - x- (the reference instead
    big-M-shifts them by -1e8, `preprocess.m:34-36`, which destroys
    absolute accuracy); NaN or +inf lower bounds are rejected as malformed
  * inequality rows gain slack columns
  * finite upper bounds become extra rows  x'_j + t_j = ub_j - lb_j
  * A_std = [[Aeq, 0, 0], [Aineq, I, 0], [D, 0, I]]  (`preprocess.m:49-52`)

Two-sided rows (RANGES) are split into their <= and >= parts first.
`recover(x_std)` maps a standard-form solution back to original variables.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import scipy.sparse as sp

from .mps import GeneralLP

BIG_LB = 1e8   # `preprocess.m:34-36` (documented, not used: we free-split)


@dataclasses.dataclass
class StandardFormLP:
    A: sp.csc_matrix
    b: np.ndarray
    c: np.ndarray
    objcon_shift: float   # (signed c) @ lb -- added inside the signed space
    objcon_user: float    # the MPS objective constant -- added after unsigning
    n_orig: int
    maximize: bool
    recover: Callable[[np.ndarray], np.ndarray]
    sparsity: float = 0.0

    def user_objective(self, std_obj: float) -> float:
        """Map a standard-form objective value back to the user's problem."""
        sign = -1.0 if self.maximize else 1.0
        return sign * (std_obj + self.objcon_shift) + self.objcon_user


def presolve_to_standard(p: GeneralLP) -> StandardFormLP:
    A = p.A.tocsr()
    m, n = A.shape
    c = p.c.copy()
    sign = -1.0 if p.maximize else 1.0
    c = sign * c

    # split rows into equality / one-sided inequality parts
    eq_rows, le_rows, ge_rows = [], [], []
    for i in range(m):
        lo, hi = p.row_lo[i], p.row_hi[i]
        if lo == hi:
            eq_rows.append(i)
        else:
            if np.isfinite(hi):
                le_rows.append(i)
            if np.isfinite(lo):
                ge_rows.append(i)

    Aeq = A[eq_rows]
    beq = p.row_hi[eq_rows]
    # Ax <= hi and -Ax <= -lo in one inequality block
    Ain = sp.vstack(
        [A[le_rows], -A[ge_rows]], format="csr"
    ) if (le_rows or ge_rows) else sp.csr_matrix((0, n))
    bin_ = np.concatenate([p.row_hi[le_rows], -p.row_lo[ge_rows]])

    # lower-bound shift (`preprocess.m:31-36`), EXCEPT free variables:
    # the reference uses a -1e8 big-M shift for lb = -inf, which destroys
    # absolute accuracy at relative tolerances; we split those into
    # x = x+ - x- instead (extra negated columns appended after n).
    if np.isnan(p.lb).any() or np.isnan(p.ub).any():
        raise ValueError("NaN variable bound in LP data")
    if (np.isinf(p.lb) & (p.lb > 0)).any():
        raise ValueError("lower bound +inf: problem is trivially infeasible")
    lb = np.where(np.isfinite(p.lb), p.lb, 0.0)
    free_mask = np.isinf(p.lb) & (p.lb < 0)
    free_idx = np.nonzero(free_mask)[0]
    n_free = len(free_idx)

    # finite upper bounds -> extra rows (`preprocess.m:39-45`)
    ub_mask = np.isfinite(p.ub)
    ub_idx = np.nonzero(ub_mask)[0]
    m3 = len(ub_idx)
    D = sp.csr_matrix(
        (np.ones(m3), (np.arange(m3), ub_idx)), shape=(m3, n)
    )
    brhs = p.ub[ub_idx] - lb[ub_idx]

    m1, m2 = Aeq.shape[0], Ain.shape[0]
    A_std = sp.bmat(
        [
            [Aeq, None, None],
            [Ain, sp.eye(m2, format="csr"), None],
            [D, sp.csr_matrix((m3, m2)), sp.eye(m3, format="csr")],
        ],
        format="csc",
    )
    b_std = np.concatenate([
        beq - Aeq @ lb,
        bin_ - Ain @ lb,
        brhs,
    ])
    c_std = np.concatenate([c, np.zeros(m2 + m3)])

    if n_free:
        # negated copies of the free columns: x_j = x+_j - x-_j
        A_std = sp.hstack([A_std, -A_std[:, free_idx]], format="csc")
        c_std = np.concatenate([c_std, -c_std[free_idx]])

    M, N = A_std.shape
    neg_col0 = n + m2 + m3

    def recover(x_std: np.ndarray) -> np.ndarray:
        x = x_std[:n] + lb
        if n_free:
            x = x.copy()
            x[free_idx] -= x_std[neg_col0 : neg_col0 + n_free]
        return x

    return StandardFormLP(
        A=A_std, b=b_std, c=c_std,
        objcon_shift=float(c @ lb), objcon_user=p.objcon,
        n_orig=n, maximize=p.maximize, recover=recover,
        sparsity=A_std.nnz / max(1, M * N),
    )


def pad_standard(std: StandardFormLP, bucket: int) -> StandardFormLP:
    """Pad a standard-form LP to shape multiples of `bucket`.

    Suite runs recompile the jitted solver per (m, n) shape; bucketing
    collapses similar instances onto shared shapes so the jit cache is
    reused (12 netlib-mini shapes -> 5 at bucket=128).  Padding is
    solution-preserving: each padded row is a singleton `x_pad_i = 0`
    (keeps A full row rank -- no zero rows), every padded column gets
    objective +1 so it is driven to 0, and `recover` truncates before
    mapping back to user variables.
    """
    m0, n0 = std.A.shape
    M = -(-m0 // bucket) * bucket
    N = -(-n0 // bucket) * bucket
    if N - n0 < M - m0:          # one singleton column per padded row
        N += bucket
    if (M, N) == (m0, n0):
        return std
    nr, nc = M - m0, N - n0
    A = sp.lil_matrix((M, N))
    A[:m0, :n0] = std.A
    for i in range(nr):
        A[m0 + i, n0 + i] = 1.0
    A = A.tocsc()
    b = np.concatenate([std.b, np.zeros(nr)])
    c = np.concatenate([std.c, np.ones(nc)])
    inner_recover = std.recover
    return StandardFormLP(
        A=A, b=b, c=c,
        objcon_shift=std.objcon_shift, objcon_user=std.objcon_user,
        n_orig=std.n_orig, maximize=std.maximize,
        recover=lambda x_std: inner_recover(x_std[:n0]),
        sparsity=A.nnz / max(1, M * N),
    )


def solve_mps(path: str, settings=None, dense: bool = True,
              method: str = "abip", pad_bucket: int = 0, device=None,
              **overrides):
    """Read an MPS file, presolve to standard form, solve, map back.

    Returns (solution, standard_form).  The reported objective includes the
    presolve constant and the min/max sign flip.  `method` selects the
    solver on the standard form: "abip" (`solve_lp`; with dense=False its
    scipy sparse A runs through K5 on the card) or "device" (the batched
    `device_solve_lp` with a lane axis of 1) or "pdhg" (the restarted
    PDHG competitor, `pdhg.solve_lp_pdhg`).  The solve runs on the CUDA
    card unless `device` says otherwise.
    """
    from .mps import read_mps
    from ..lp import solve_lp
    from ..settings import Settings

    p = read_mps(path)
    std = presolve_to_standard(p)
    if pad_bucket:
        std = pad_standard(std, pad_bucket)
    A = std.A.toarray() if dense else std.A
    if method == "pdhg":
        from ..pdhg import solve_lp_pdhg

        sol = solve_lp_pdhg(A.toarray() if sp.issparse(A) else A, std.b,
                            std.c, device=device, **overrides)
    elif method == "device":
        # the whole solve as one batched device program
        # (`abip_tpu/io/presolve.py:199-252`), at B=1
        if settings is not None:
            raise ValueError(
                "method='device' does not take a Settings object "
                "(device_solve_lp has its own keyword set); pass its "
                "options as keyword overrides instead")
        import time as _time

        import torch

        from ..device import resolve_device
        from ..lp import LPSolution
        from ..parallel.batched import device_solve_lp
        from ..settings import Status

        dev = resolve_device(device)
        dkw = dict(precision="mixed", solver="inverse", qres_period=16,
                   avg_period=20)
        dkw.update(overrides)
        t0 = _time.perf_counter()

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                   device=dev)[None]

        r = device_solve_lp(t(A.toarray() if sp.issparse(A) else A),
                            t(std.b), t(std.c), **dkw)
        keys = ("status", "pobj", "dobj", "res_pri", "res_dual", "rel_gap",
                "ipm_iters", "admm_iters")
        head = dict(zip(keys, torch.stack(          # one device read
            [getattr(r, k)[0].double() for k in keys]).tolist()))
        code = int(head["status"])
        sol = LPSolution(
            x=r.x[0].cpu().numpy(), y=r.y[0].cpu().numpy(),
            s=r.s[0].cpu().numpy(), status=code,
            status_name=Status.name(code),
            pobj=head["pobj"], dobj=head["dobj"],
            res_pri=head["res_pri"], res_dual=head["res_dual"],
            rel_gap=head["rel_gap"], res_infeas=float("nan"),
            res_unbdd=float("nan"), ipm_iters=int(head["ipm_iters"]),
            admm_iters=int(head["admm_iters"]), setup_time=0.0,
            solve_time=_time.perf_counter() - t0,
        )
    elif method == "abip":
        sol = solve_lp(A, std.b, std.c, settings or Settings(),
                       device=device, **overrides)
    else:
        raise ValueError(f"unknown method {method!r}")
    sol.pobj = std.user_objective(sol.pobj)
    sol.dobj = std.user_objective(sol.dobj)
    sol.x_std = sol.x            # standard-form iterate (crossover input)
    sol.x = std.recover(sol.x)
    return sol, std


def save_presolved_mps(in_path: str, out_path: str,
                       pad_bucket: int = 0) -> "StandardFormLP":
    """Presolve an MPS file and save the standard form back as MPS.

    The `prepare.m`/`save_abip_mps.m` role in the reference bench layer
    (presolve once, reuse the standard-form file across solver runs).
    Returns the StandardFormLP that was written.
    """
    from .mps import GeneralLP, read_mps
    from .mps_write import write_mps

    std = presolve_to_standard(read_mps(in_path))
    if pad_bucket:
        std = pad_standard(std, pad_bucket)
    m, n = std.A.shape
    # preserve the user objective across the round-trip: write the
    # UNSIGNED cost with the original OBJSENSE and fold the presolve
    # shift + original constant into the file's objective constant, so
    # re-parsing yields user_objective identical to the original file's
    # (std.c is the signed minimize cost; sign*(std+shift)+objcon_user)
    sign = -1.0 if std.maximize else 1.0
    p = GeneralLP(c=sign * std.c, A=sp.csc_matrix(std.A),
                  row_lo=std.b, row_hi=std.b,
                  lb=np.zeros(n), ub=np.full(n, np.inf),
                  objcon=sign * std.objcon_shift + std.objcon_user,
                  maximize=std.maximize, name="PRESOLVED")
    write_mps(p, out_path)
    return std
