"""Indirect KKT backend: Jacobi-preconditioned conjugate gradients.

Port of `abip_tpu/linsys/cg.py`, the reference PCG backend
(`src/abip-lp/linsys/indirect.c:321-434`):

  * operator: G y = rho_y * y + A (A^T y)   (normal equations, matrix-free)
  * preconditioner: M = diag(G)^-1 = 1 / (rho_y + row_norms_sq(A))
    (`indirect.c:36-79`)
  * tolerance schedule: ||rhs|| * CG_MIN_TOL / (iter+1)^cg_rate, floored at
    1e-7; CG_BEST_TOL=1e-9 for the one-time setup solve (`indirect.c:406-409`)
  * warm start from the previous iterate (`indirect.c:344-352`)

The reference's `lax.while_loop` is a host loop here: the stop test
`||r|| >= tol` is read from the device once per CG iteration, so the
iteration count is exactly the reference's.  `pcg_block` runs
`PCG_BLOCK` iterations of the same loop with the stop test on the
device: an iteration runs only while `pcg_running` holds and leaves the
state as it was once it fails, so a host that reads the test once a
block stops where the loop would have, with its x and count (the Schur
PCG's CUDA graphs, `linsys.schur`).  `pcg_lanes` is the same
loop over a `(B, m)` stack of independent systems, the reference's
`pcg` under `vmap`: a lane whose residual is below its tolerance (or at
its iteration cap) is frozen, and the host reads "any lane running"
only every `_CG_SYNC` iterations.
"""
from __future__ import annotations

import torch

from ..utils.profiling import host_read

CG_BEST_TOL = 1e-9
CG_MIN_TOL = 1e-1
# `pcg_lanes`: CG iterations between two host reads of "any lane running"
_CG_SYNC = 4
# `pcg_block`: CG iterations of a block
PCG_BLOCK = 10


def _above(x, tol) -> bool:
    """x >= tol, read on the host."""
    with host_read():
        return bool(x >= tol)


def pcg_start(G, M, b, x0):
    """The residual, the first direction and <z, r> at x0."""
    r = b - G(x0)
    z = M * r
    return r, z, (z * r).sum()


def _pcg_iteration(G, M, x, r, p, ipzr):
    """One CG step from (x, r, p, <z, r>), as `pcg` and `pcg_block` take
    it."""
    Gp = G(p)
    alpha = ipzr / (p * Gp).sum()
    x = x + alpha * p
    r = r - alpha * Gp
    z = M * r
    ipzr_new = (z * r).sum()
    p = z + (ipzr_new / ipzr) * p
    return x, r, p, ipzr_new


def pcg(G, M, b, x0, tol, max_iters):
    """Jacobi-preconditioned CG: solve G(x) = b to ||r|| < tol.

    Mirrors `pcg` (`indirect.c:321-391`).  Returns (x, iterations) with
    the iteration count a Python int."""
    x = x0
    r, p, ipzr = pcg_start(G, M, b, x)
    i = 0
    while i < max_iters and _above(torch.linalg.vector_norm(r), tol):
        x, r, p, ipzr = _pcg_iteration(G, M, x, r, p, ipzr)
        i += 1
    return x, i


def pcg_running(r, its, tol, cap):
    """`pcg`'s loop test on the device: its < cap and ||r|| >= tol, a 0-d
    bool tensor."""
    return (its < cap) & (torch.linalg.vector_norm(r) >= tol)


def pcg_block(G, M, x, r, p, ipzr, its, tol, cap):
    """PCG_BLOCK iterations of `pcg`'s loop from (x, r, p, <z, r>) after
    `its` iterations (a 0-d int64 tensor), each applied only while
    `pcg_running` holds (tol and the cap `cap` are 0-d tensors): once
    the test fails, x, r, p, <z, r> and `its` stay as they were, and
    none of the test's inputs moves again, so the block ends where the
    loop would have.  An iteration that runs does `pcg`'s arithmetic.
    Returns ((x, r, p, ipzr, its), whether the loop goes on)."""
    for _ in range(PCG_BLOCK):
        run = pcg_running(r, its, tol, cap)
        x_n, r_n, p_n, ipzr_n = _pcg_iteration(G, M, x, r, p, ipzr)
        x = torch.where(run, x_n, x)
        r = torch.where(run, r_n, r)
        p = torch.where(run, p_n, p)
        ipzr = torch.where(run, ipzr_n, ipzr)
        its = its + run.to(its.dtype)
    return (x, r, p, ipzr, its), pcg_running(r, its, tol, cap)


def cg_tolerance(rhs_norm, iter_count, cg_rate, dtype):
    """Decaying tolerance schedule (`indirect.c:406-409`); a 0-d tensor
    on `rhs_norm`'s device."""
    it = float(iter_count)
    sched = torch.tensor(
        CG_BEST_TOL if it < 0 else CG_MIN_TOL / (max(it, 0.0) + 1.0) ** cg_rate,
        dtype=dtype)
    return torch.clamp(rhs_norm * sched.to(rhs_norm.device), min=1e-7)


def pcg_lanes(G, M, b, x0, tol, max_iters, active=None):
    """`pcg` on B independent systems at once: G maps `(B, m)` to
    `(B, m)`, M is the `(B, m)` Jacobi preconditioner, `tol` the `(B,)`
    per-lane stop tolerance, `max_iters` an int or `(B,)` caps.

    A lane runs while ||r|| >= tol and its count is below its cap, and
    only while `active` (a `(B,)` mask, default all): once stopped it is
    frozen (x, r, p and its count no longer change), so stopping is
    monotone and the host reads the stop test only every `_CG_SYNC`
    iterations; the counts are those of a per-lane while loop.  Returns
    (x, `(B,)` int32 iteration counts)."""
    B = b.shape[0]
    dev = b.device
    cap = torch.as_tensor(max_iters, device=dev).to(torch.int32).expand(B)
    x = x0
    r = b - G(x)
    z = M * r
    p = z
    ipzr = (z * r).sum(-1)
    its = torch.zeros((B,), dtype=torch.int32, device=dev)
    run_mask = torch.ones((B,), dtype=torch.bool, device=dev) \
        if active is None else active
    t = 0
    while True:
        run = run_mask & (torch.linalg.vector_norm(r, dim=-1) >= tol) \
            & (its < cap)
        if t % _CG_SYNC == 0 and not bool(run.any()):
            break
        t += 1
        Gp = G(p)
        alpha = ipzr / (p * Gp).sum(-1)
        x_n = x + alpha[:, None] * p
        r_n = r - alpha[:, None] * Gp
        z = M * r_n
        ipzr_new = (z * r_n).sum(-1)
        p_n = z + (ipzr_new / ipzr)[:, None] * p
        rc = run[:, None]
        x = torch.where(rc, x_n, x)
        r = torch.where(rc, r_n, r)
        p = torch.where(rc, p_n, p)
        ipzr = torch.where(run, ipzr_new, ipzr)
        its = its + run.to(torch.int32)
    return x, its


def cg_tolerance_lanes(rhs_norm, iter_count, cg_rate):
    """`cg_tolerance` per lane: `rhs_norm` and `iter_count` are `(B,)`
    tensors, as the reference's schedule is traced on a per-lane count
    under `vmap` (`indirect.c:406-409`)."""
    it = iter_count.to(rhs_norm.dtype)
    sched = torch.where(
        it < 0, torch.full_like(it, CG_BEST_TOL),
        CG_MIN_TOL / torch.pow(torch.clamp(it, min=0.0) + 1.0, cg_rate))
    return torch.clamp(rhs_norm * sched, min=1e-7)


class CGSolver:
    """Matrix-free CG on (rho_y I + A A^T) z_y = w_y + A w_x."""

    def __init__(self, A_op, m, n, rho_y, settings):
        self.A_op = A_op
        self.m = m
        self.n = n
        self.rho_y = rho_y
        self.cg_rate = settings.cg_rate
        self.max_iters = min(settings.cg_max_iters, max(2 * m, 10))
        # Jacobi preconditioner: 1 / (rho_y + ||A_i,:||^2) per row.
        if A_op.has_dense:
            A = A_op.dense()
            row_sq = (A * A).sum(dim=1)
        else:
            # Operators that know their diagonal pass it via `row_norms_sq`;
            # otherwise the preconditioner is the identity scaled by 1/rho_y.
            row_sq = getattr(A_op, "row_norms_sq", None)
            if row_sq is None:
                row_sq = torch.zeros((m,), dtype=torch.float64)
        self.M = 1.0 / (rho_y + row_sq)

    def _G(self, y):
        return self.rho_y * y + self.A_op.matvec(self.A_op.rmatvec(y))

    def solve(self, w_y, w_x, iter_count=0, warm_start=None):
        """Solve K z = (w_y, w_x) via normal equations + PCG; returns
        (z_y, z_x, cg_iterations)."""
        rhs = w_y + self.A_op.matvec(w_x)
        tol = cg_tolerance(torch.linalg.vector_norm(rhs), iter_count,
                           self.cg_rate, rhs.dtype)
        x0 = warm_start if warm_start is not None else torch.zeros_like(w_y)
        z_y, iters = pcg(self._G, self.M.to(rhs.device), rhs, x0, tol,
                         self.max_iters)
        z_x = self.A_op.rmatvec(z_y) - w_x
        return z_y, z_x, iters
