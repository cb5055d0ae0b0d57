"""Unified front door: dispatch LP vs conic on problem structure.

Port of `abip_tpu/dispatch.py` (the reference's MATLAB dispatcher,
`scripts/matlab/abip.m:22-28`): a problem with a quadratic term or
non-orthant cones routes to the host conic driver; a plain
`Ax = b, x >= 0` problem takes the host LP driver.  Every entry runs on
the CUDA card unless `device` says otherwise.
"""
from __future__ import annotations


def solve(A, b, c, cones=None, Q=None, settings=None, device=None,
          **overrides):
    """Solve min (1/2)x'Qx + c'x s.t. Ax = b, x in K.

    cones: a `ConeSpec`, or None for K = R+^n (LP).  Returns an
    `LPSolution` or `ConicSolution` accordingly."""
    from .cones import ConeSpec

    n = A.shape[1]
    lp_shaped = Q is None and (
        cones is None
        or (isinstance(cones, ConeSpec)
            and not cones.soc and not cones.rsoc
            and cones.free == 0 and cones.zero == 0
            and cones.nonneg == n)
    )
    if lp_shaped:
        from .lp import solve_lp
        from .settings import Settings

        return solve_lp(A, b, c, settings or Settings(), device=device,
                        **overrides)

    from .qcp import conic_defaults, solve_qcp

    if cones is None:
        cones = ConeSpec.lp(n)
    return solve_qcp(A, b, c, cones, Q=Q,
                     settings=settings or conic_defaults(), device=device,
                     **overrides)


def solve_general(A, c, row_lo=None, row_hi=None, lb=None, ub=None,
                  objcon=0.0, maximize=False, settings=None, device=None,
                  **overrides):
    """Solve a general-form LP without going through an MPS file:

        min/max c'x + objcon   s.t.  row_lo <= A x <= row_hi,
                                     lb <= x <= ub.

    The problem is presolved to standard form (`io/presolve.py`, free
    variables split), solved by `solve_lp`, and mapped back
    (`abip_tpu/dispatch.py:47-88`).  `None` bounds mean unbounded on that
    side.  A standard form with sparsity above 0.25 goes dense; a sparser
    one keeps its scipy sparse A, whose products launch K5 on the card.
    """
    import numpy as np
    import scipy.sparse as sp

    from .io.mps import GeneralLP
    from .io.presolve import presolve_to_standard
    from .lp import solve_lp
    from .settings import Settings

    A = sp.csc_matrix(A)
    m, n = A.shape
    c = np.asarray(c, float).ravel()
    full = lambda v, d: np.full(m if d == "m" else n, v, float)  # noqa: E731
    row_lo = full(-np.inf, "m") if row_lo is None \
        else np.asarray(row_lo, float).ravel()
    row_hi = full(np.inf, "m") if row_hi is None \
        else np.asarray(row_hi, float).ravel()
    lb = full(0.0, "n") if lb is None else np.asarray(lb, float).ravel()
    ub = full(np.inf, "n") if ub is None else np.asarray(ub, float).ravel()

    p = GeneralLP(c=c, A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
                  objcon=float(objcon), maximize=bool(maximize))
    std = presolve_to_standard(p)
    dense = std.A.toarray() if std.sparsity > 0.25 else std.A
    sol = solve_lp(dense, std.b, std.c, settings or Settings(),
                   device=device, **overrides)
    sol.pobj = std.user_objective(sol.pobj)
    sol.dobj = std.user_objective(sol.dobj)
    sol.x_std = sol.x
    sol.x = std.recover(sol.x)
    return sol
