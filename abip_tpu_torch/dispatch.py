"""Unified front door: dispatch LP vs conic on problem structure.

Port of `abip_tpu/dispatch.py` (the reference's MATLAB dispatcher,
`scripts/matlab/abip.m:22-28`): a plain `Ax = b, x >= 0` problem takes
the host LP driver.  The host conic driver and the general-form LP
entry are not ported yet and raise.
"""
from __future__ import annotations


def solve(A, b, c, cones=None, Q=None, settings=None, device=None,
          **overrides):
    """Solve min (1/2)x'Qx + c'x s.t. Ax = b, x in K.

    cones: a `ConeSpec`, or None for K = R+^n (LP).  LP-shaped problems
    return an `LPSolution`; the solve runs on the CUDA card unless
    `device` says otherwise."""
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
    raise NotImplementedError(
        "the host conic driver (solve_qcp) is not ported to abip_tpu_torch "
        "yet (ROADMAP.md queue 1, item 9); batches of same-shape conic "
        "programs run through solve_qcp_batch")


def solve_general(*args, **kw):
    """The general-form LP entry (presolve to standard form) is not
    ported yet."""
    raise NotImplementedError(
        "solve_general (presolve, io/) is not ported to abip_tpu_torch yet "
        "(ROADMAP.md queue 1, item 13)")
