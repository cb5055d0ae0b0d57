"""Crossover: polish an interior solution to an optimal basic solution.

A copy of `abip_tpu/crossover.py` (numpy on the host, so its results are
bit-identical to the reference's); the port keeps its own copy.

The reference validates first-order solutions by crossing over to a
vertex with an external solver (`scripts/bench-lp/
crossover_by_copt.py:1-48` hands ABIP's (x, y) to COPT).  This module
does the crossover natively: from an eps-accurate interior point it
identifies a candidate basis, solves the basic system exactly, and
verifies primal feasibility + reduced-cost optimality, returning a
vertex solution with a clean certificate.

Method (host-side, setup-cost class — not a hot path):

1. Rank the columns by the interior magnitude `x_j` (an eps-accurate
   interior point concentrates mass on the optimal support).
2. QR with column pivoting on the support-ordered columns picks `m`
   independent basis columns (largest-x first).
3. Solve `A_B x_B = b` exactly; nonbasic entries are 0.
4. Dual: solve `A_B' y = c_B`; reduced costs `r = c - A'y`.
5. Certify: `x_B >= -tol`, `||A x - b|| <= tol*(1+||b||)`,
   `r >= -tol` — if all hold the vertex is optimal to `tol`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CrossoverResult:
    x: np.ndarray
    y: np.ndarray
    basis: np.ndarray            # column indices, length m
    pobj: float
    dobj: float
    primal_feas: float           # ||Ax - b|| / (1 + ||b||)
    min_x: float                 # most negative basic variable
    min_reduced_cost: float      # most negative reduced cost
    optimal: bool


def _greedy_basis(A, x, m, indep_tol: float = 1e-8) -> np.ndarray:
    """Greedy x-priority basis: scan columns in decreasing interior
    magnitude, keep each column whose component orthogonal to the span
    of the kept ones is non-negligible (modified Gram-Schmidt with
    reorthogonalization).  Unlike norm-pivoted QR on x-scaled columns,
    this respects the support order exactly and completes degenerate
    bases (flow/transportation LPs) with well-conditioned columns.
    """
    n = A.shape[1]
    order = np.argsort(-x)
    Q = np.zeros((m, min(m, n)))
    k = 0
    basis = []
    for j in order:
        a = A[:, j]
        na = np.linalg.norm(a)
        if na <= 0.0:
            continue
        r = a - Q[:, :k] @ (Q[:, :k].T @ a)
        r = r - Q[:, :k] @ (Q[:, :k].T @ r)      # reorthogonalize
        nr = np.linalg.norm(r)
        if nr > indep_tol * na:
            Q[:, k] = r / nr
            k += 1
            basis.append(j)
            if k == m:
                break
    return np.sort(np.asarray(basis, int))


def _pivot_to_optimal(A, b, c, basis, tol, max_pivots=200):
    """Primal simplex pivots from a feasible basis to an optimal one.

    The greedy basis is primal-optimal (it carries the interior
    solution's support) but at a degenerate vertex it may not be dual
    feasible — the same vertex admits several bases, and only some have
    all-nonnegative reduced costs.  A handful of (mostly degenerate,
    objective-preserving) pivots fixes that.  Bland's rule everywhere:
    finite termination under degeneracy.  Factors are recomputed per
    pivot — polish-path economics, not a hot loop.
    """
    m = A.shape[0]
    basis = np.array(basis, int)
    for _ in range(max_pivots):
        AB = A[:, basis]
        xB, *_ = np.linalg.lstsq(AB, b, rcond=None)
        y, *_ = np.linalg.lstsq(AB.T, c[basis], rcond=None)
        r = c - A.T @ y
        r[basis] = 0.0
        neg = np.flatnonzero(r < -tol)
        if neg.size == 0:
            return basis, xB, y, r
        e = neg[0]                                    # Bland: lowest index
        d, *_ = np.linalg.lstsq(AB, A[:, e], rcond=None)
        pos = np.flatnonzero(d > 1e-10)
        if pos.size == 0:
            break                                     # unbounded direction
        ratios = np.maximum(xB[pos], 0.0) / d[pos]
        t = ratios.min()
        ties = pos[np.flatnonzero(ratios <= t + 1e-12)]
        leave = ties[np.argmin(basis[ties])]          # Bland tie-break
        basis[leave] = e
        basis = np.sort(basis)
    AB = A[:, basis]
    xB, *_ = np.linalg.lstsq(AB, b, rcond=None)
    y, *_ = np.linalg.lstsq(AB.T, c[basis], rcond=None)
    r = c - A.T @ y
    return basis, xB, y, r


def crossover(A, b, c, x, tol: float = 1e-7) -> CrossoverResult:
    """Polish interior point `x` of `min c'x, Ax=b, x>=0` to a vertex.

    Returns a `CrossoverResult`; `optimal=True` means the vertex passed
    primal feasibility and reduced-cost checks at `tol` — an exact-basis
    certificate strengthening the eps-accurate first-order solution.
    """
    A = np.asarray(A, float)
    b = np.asarray(b, float).ravel()
    c = np.asarray(c, float).ravel()
    x = np.asarray(x, float).ravel()
    m, n = A.shape

    basis = _greedy_basis(A, x, m)
    basis, xB, y, r = _pivot_to_optimal(A, b, c, basis, tol)

    x_out = np.zeros(n)
    x_out[basis] = xB

    pfeas = np.linalg.norm(A @ x_out - b) / (1.0 + np.linalg.norm(b))
    min_x = float(xB.min()) if xB.size else 0.0
    min_rc = float(r.min())
    optimal = (pfeas <= tol) and (min_x >= -tol) and (min_rc >= -tol)
    return CrossoverResult(
        x=x_out, y=y, basis=basis,
        pobj=float(c @ x_out), dobj=float(b @ y),
        primal_feas=float(pfeas), min_x=min_x, min_reduced_cost=min_rc,
        optimal=bool(optimal),
    )
