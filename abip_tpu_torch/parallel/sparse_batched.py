"""Batched SAME-PATTERN sparse LPs on one device: sparse products + PCG.

Port of `abip_tpu/parallel/sparse_batched.py`.  A FAMILY of instances
shares one sparse pattern (`rows`, `cols`, rows sorted) with per-lane
values `(B, nnz)` -- graph suites such as PageRank families are exactly
this shape -- and every lane runs the reference's indirect regime
(`indirect.c:321-434`): matrix-free PCG on the normal equations with a
Jacobi preconditioner and the decaying tolerance ladder, inside the f64
steps engine at chunk cadence (`abip.c:2056-2297`).

The pattern is sorted once, on the host, into a padded row table (the
stored entries of each row, in order) and a padded column table (those
of each column), so that A x and A' y are a gather and a sum along a
fixed axis: a reduction of fixed order, which gives the same bits from
run to run on the card (a scatter-add over unsorted columns would add
with atomics, in no fixed order, and a CG stop near its tolerance would
then move the ADMM counts).  The row and column maxima of the
equilibration are order-free `amax` reductions over the same tables.

The reference's four nested `while_loop`s under `vmap` (barrier stages,
chunks, micro-trips of `probe_period` iterations, PCG) are host loops
over lane-masked tensors: each lane's counters and status live on the
lane axis, every decision is a mask, a lane whose loop condition is
false is frozen, and the host reads only "does any lane continue" once
per micro-trip, chunk and stage, and every few CG iterations
(`linsys.cg.pcg_lanes`).  So lane b of a B-lane solve equals the
one-lane solve of the same instance.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import hsd
from ..device import resolve_device
from ..linsys.cg import CG_BEST_TOL, cg_tolerance_lanes, pcg_lanes
from .batched import DeviceSolveResult, _select

f64 = torch.float64
i32 = torch.int32


def _padded_table(keys, size):
    """(size, width) int64 table of the entry indices of each key, in
    index order, padded with len(keys) (the index of an appended zero)."""
    nnz = keys.shape[0]
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=size)
    width = max(1, int(counts.max()) if nnz else 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(nnz) - np.repeat(starts, counts)
    table = np.full((size, width), nnz, np.int64)
    table[keys[order], slot] = order
    return table


class SharedPattern(NamedTuple):
    """The shared sparsity pattern of a family, as padded tables.

    Row r of A stores the entries `row_entries[r]` (indices into a
    lane's values, padded with nnz) at columns `row_cols[r]` (padded
    with 0); column j stores `col_entries[j]` at rows `col_rows[j]`."""

    m: int
    n: int
    nnz: int
    rows: torch.Tensor           # (nnz,) int64 row of each entry
    cols: torch.Tensor           # (nnz,) int64 column of each entry
    row_entries: torch.Tensor    # (m, wr) int64
    row_cols: torch.Tensor       # (m, wr) int64
    col_entries: torch.Tensor    # (n, wc) int64
    col_rows: torch.Tensor       # (n, wc) int64

    @staticmethod
    def from_coo(rows, cols, m, n, device=None) -> "SharedPattern":
        rows = np.asarray(rows, np.int64).ravel()
        cols = np.asarray(cols, np.int64).ravel()
        if rows.shape != cols.shape:
            raise ValueError(f"rows {rows.shape} and cols {cols.shape} differ")
        if rows.size and (rows.min() < 0 or rows.max() >= m
                          or cols.min() < 0 or cols.max() >= n):
            raise ValueError(f"pattern outside a {m} x {n} matrix")
        rt = _padded_table(rows, m)
        ct = _padded_table(cols, n)
        ext_c = np.concatenate([cols, [0]])
        ext_r = np.concatenate([rows, [0]])

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        return SharedPattern(m, n, rows.size, t(rows), t(cols), t(rt),
                             t(ext_c[rt]), t(ct), t(ext_r[ct]))

    def by_rows(self, vals):
        """`(B, m, wr)` values of each row's entries (0 in the padding)."""
        ext = torch.cat([vals, torch.zeros_like(vals[:, :1])], dim=1)
        return ext[:, self.row_entries]

    def by_cols(self, vals):
        """`(B, n, wc)` values of each column's entries."""
        ext = torch.cat([vals, torch.zeros_like(vals[:, :1])], dim=1)
        return ext[:, self.col_entries]


class CooOperator(NamedTuple):
    """A and A' of one family's lanes: the values laid out by rows and by
    columns once, so that each product is one gather and one sum."""

    pattern: SharedPattern
    VR: torch.Tensor     # (B, m, wr)
    VC: torch.Tensor     # (B, n, wc)

    @staticmethod
    def of(pattern: SharedPattern, vals) -> "CooOperator":
        return CooOperator(pattern, pattern.by_rows(vals),
                           pattern.by_cols(vals))

    def matvec(self, x):
        """A x for `(B, n)` x."""
        return (self.VR * x[:, self.pattern.row_cols]).sum(-1)

    def rmatvec(self, y):
        """A' y for `(B, m)` y."""
        return (self.VC * y[:, self.pattern.col_rows]).sum(-1)


def coo_matvec(pattern: SharedPattern, vals, x):
    """y = A x over a lane stack of values `(B, nnz)` and `(B, n)` x."""
    return CooOperator.of(pattern, vals).matvec(x)


def coo_rmatvec(pattern: SharedPattern, vals, y):
    """x = A' y over the same pattern."""
    return CooOperator.of(pattern, vals).rmatvec(y)


def _equilibrate_coo(pattern: SharedPattern, vals, iters=10):
    """Ruiz equilibration on the values (`_normalize_A`,
    `common.c:150-565`, sparse form; `sparse_batched.py:57-81`): iterated
    sqrt-inf-norm row/col scaling, plus the mean row/col L2 norms that
    feed b/c normalization (`normalize.c:11-40`).  Returns (values,
    D, E, mean row norm, mean column norm), D and E as DIVISORS
    (A_s = A / (D E)), per lane."""
    B = vals.shape[0]
    D = torch.ones((B, pattern.m), dtype=vals.dtype, device=vals.device)
    E = torch.ones((B, pattern.n), dtype=vals.dtype, device=vals.device)
    for _ in range(iters):
        av = vals.abs()
        r = pattern.by_rows(av).amax(-1)
        cmax = pattern.by_cols(av).amax(-1)
        dr = 1.0 / torch.sqrt(torch.clamp(r, min=1e-12))
        dc = 1.0 / torch.sqrt(torch.clamp(cmax, min=1e-12))
        vals = vals * dr[:, pattern.rows] * dc[:, pattern.cols]
        D, E = D * dr, E * dc
    sq = vals * vals
    row_l2 = torch.sqrt(pattern.by_rows(sq).sum(-1))
    col_l2 = torch.sqrt(pattern.by_cols(sq).sum(-1))
    return vals, 1.0 / D, 1.0 / E, row_l2.mean(-1), col_l2.mean(-1)


class _Outer(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    mu: torch.Tensor
    i: torch.Tensor
    k: torch.Tensor
    final_check: torch.Tensor
    status: torch.Tensor
    res: hsd.LPResiduals


class _Inner(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    u_sum: torch.Tensor
    v_sum: torch.Tensor
    avg_crit: torch.Tensor
    j: torch.Tensor
    k: torch.Tensor
    qres: torch.Tensor
    status: torch.Tensor
    res: hsd.LPResiduals


def _solve_coo(pattern, vals, b, c, *, eps, max_ipm, max_admm, alpha, rho_y,
               gamma0, sigma0, hybrid_thresh, dynamic_x, dynamic_eta,
               shrink_second, cg_rate, cg_max_iters, qres_period,
               probe_period, info=None) -> DeviceSolveResult:
    """The f64 steps engine at chunk cadence with warm-started PCG
    (`sparse_batched.py:83-293`) for every lane of the family."""
    m, n = pattern.m, pattern.n
    B = vals.shape[0]
    dev = vals.device
    l = m + n + 1

    nm_b0 = torch.linalg.vector_norm(b, dim=-1)
    nm_c0 = torch.linalg.vector_norm(c, dim=-1)
    # sparse equilibration + b/c normalization (`normalize.c:11-40`)
    vals, D, E, mnr, mnc = _equilibrate_coo(pattern, vals)
    c_s = c / E
    sc_c = mnr / torch.clamp(torch.linalg.vector_norm(c_s, dim=-1), min=1e-3)
    b_s = b / D
    sc_b = mnc / torch.clamp(torch.linalg.vector_norm(b_s, dim=-1), min=1e-3)
    b = b_s * sc_b[:, None]
    c = c_s * sc_c[:, None]

    op = CooOperator.of(pattern, vals)
    mv, rmv = op.matvec, op.rmatvec
    ones_scale = sc_c * sc_b
    pr_scale = D / sc_b[:, None]
    dr_scale = E / sc_c[:, None]

    # normal-equations operator + Jacobi preconditioner (`indirect.c:36-79`)
    M_pre = 1.0 / (rho_y + (op.VR * op.VR).sum(-1))
    cg_total = torch.zeros((B,), dtype=torch.int64, device=dev)

    def G(y):
        return rho_y * y + mv(rmv(y))

    def solver(active):
        def solve_fn(w_y, w_x, k, warm):
            rhs = w_y + mv(w_x)
            tol = cg_tolerance_lanes(torch.linalg.vector_norm(rhs, dim=-1),
                                     k, cg_rate)
            z_y, its = pcg_lanes(G, M_pre, rhs, warm, tol, cg_max_iters,
                                 active)
            return z_y, rmv(z_y) - w_x, its
        return solve_fn

    # h = (-b; c), g = K^-1 h at setup accuracy (`abip.c:1917-1924`)
    h = torch.cat([-b, c], dim=1)
    g_y, _ = pcg_lanes(
        G, M_pre, h[:, :m] + mv(h[:, m:]), torch.zeros_like(b),
        torch.clamp(torch.linalg.vector_norm(h, dim=-1) * CG_BEST_TOL,
                    min=1e-12), 4 * cg_max_iters)
    g_x = rmv(g_y) - h[:, m:]
    # MINUS g_x: the tau-row correction's K has +I in the (2,2) block
    g = torch.cat([g_y, -g_x], dim=1)
    g_th = (h * g).sum(-1)

    def residuals(u, v):
        return hsd.lp_residuals(u, v, mv, rmv, b, c, pr_scale, dr_scale,
                                ones_scale, nm_b0, nm_c0, m, n)

    def qres_of(u, v):
        return hsd.q_norm_resd(u, v, mv, rmv, b, c, m, n)

    def pick_avg(ac, dom, us, vs, u, v):
        a = ac[:, None]
        return (torch.where(a, us / dom[:, None], u),
                torch.where(a, vs / dom[:, None], v))

    probe = min(probe_period, qres_period)
    zl = torch.zeros((B, l), dtype=f64, device=dev)
    zi = torch.zeros((B,), dtype=i32, device=dev)

    def inner(carry: _Outer, alive) -> _Inner:
        mu = carry.mu
        thresh = gamma0 * mu

        def body_chunk(s: _Inner, act) -> _Inner:
            nonlocal cg_total
            t = (s.u, s.v, s.u_sum, s.v_sum, zi, zi, s.qres, s.avg_crit)
            while True:
                u, v, us, vs, dj, dk, q, ac = t
                mc = (act & (q >= thresh) & (dk < qres_period)
                      & (s.k + dk < max_admm))
                if not bool(mc.any()):
                    break
                solve_fn = solver(mc)
                for _ in range(probe):
                    u_t, its = hsd.project_lin_sys(u, v, h, g, g_th, rho_y,
                                                   solve_fn, s.k, m, n)
                    u, v = hsd.admm_update(u, v, u, u_t, mu, alpha, m)
                    us, vs = us + u, vs + v
                    cg_total = cg_total + its
                dj, dk = dj + probe, dk + probe
                dom = torch.clamp((s.j + dj).to(f64), min=1.0)
                q_cur = qres_of(u, v)
                q_avg = qres_of(us / dom[:, None], vs / dom[:, None])
                ac = q_avg < q_cur
                t = _select(mc, (u, v, us, vs, dj, dk,
                                 torch.where(ac, q_avg, q_cur), ac), t)
            u, v, us, vs, dj, dk, q, ac = t
            dom = torch.clamp((s.j + dj).to(f64), min=1.0)
            r = residuals(*pick_avg(ac, dom, us, vs, u, v))
            st = torch.where(
                carry.final_check,
                hsd.lp_converged_code(r, eps, False,
                                      (carry.i > 0) & (s.k + dk > 0)),
                0).to(i32)
            return _Inner(u=u, v=v, u_sum=us, v_sum=vs, avg_crit=ac,
                          j=s.j + dj, k=s.k + dk, qres=q, status=st, res=r)

        s = _Inner(u=carry.u, v=carry.v, u_sum=zl, v_sum=zl,
                   avg_crit=torch.zeros((B,), dtype=torch.bool, device=dev),
                   j=zi, k=carry.k,
                   qres=torch.full((B,), torch.inf, dtype=f64, device=dev),
                   status=zi, res=carry.res)
        while True:
            act = alive & (s.qres >= thresh) & (s.status == 0) \
                & (s.k < max_admm)
            if not bool(act.any()):
                break
            s = _select(act, body_chunk(s, act), s)
        return s

    def outer_body(carry: _Outer, alive) -> _Outer:
        s = inner(carry, alive)
        dom = torch.clamp(s.j, min=1).to(f64)
        u_sel, v_sel = pick_avg(s.avg_crit, dom, s.u_sum, s.v_sum, s.u, s.v)
        r = residuals(u_sel, v_sel)
        status = torch.where(
            s.status != 0, s.status,
            hsd.lp_converged_code(r, eps, False, (carry.i > 0) & (s.k > 0)))
        final_check = carry.final_check | (carry.mu < eps)
        mu = hsd.mu_update_hybrid(carry.mu, u_sel, v_sel, m, eps,
                                  hybrid_thresh, dynamic_x, dynamic_eta,
                                  shrink_second)
        u, v = hsd.reinit_rebalance(u_sel, v_sel, sigma0, m)
        done = status != 0
        d = done[:, None]
        return _Outer(u=torch.where(d, u_sel, u), v=torch.where(d, v_sel, v),
                      mu=torch.where(done, carry.mu, mu), i=carry.i + 1,
                      k=s.k, final_check=final_check, status=status.to(i32),
                      res=r)

    u0 = torch.cat([torch.zeros((B, m), dtype=f64, device=dev),
                    torch.ones((B, l - m), dtype=f64, device=dev)], dim=1)
    carry = _Outer(u=u0, v=u0.clone(),
                   mu=torch.ones((B,), dtype=f64, device=dev), i=zi, k=zi,
                   final_check=torch.zeros((B,), dtype=torch.bool,
                                           device=dev),
                   status=zi, res=hsd.LPResiduals.init(B, f64, dev))
    while True:
        alive = (carry.status == 0) & (carry.i < max_ipm) \
            & (carry.k < max_admm)
        if not bool(alive.any()):
            break
        carry = _select(alive, outer_body(carry, alive), carry)

    if info is not None:
        info["cg_iters"] = cg_total
    r = carry.res
    tau = torch.clamp(r.tau, min=hsd.EPS_TOL)[:, None]
    # un-normalize (`get_solution`, `abip.c:1344-1414`)
    return DeviceSolveResult(
        x=carry.u[:, m:m + n] / tau / (E * sc_b[:, None]),
        y=carry.u[:, :m] / tau / (D * sc_c[:, None]),
        s=carry.v[:, m:m + n] / tau * E / sc_c[:, None],
        status=carry.status, ipm_iters=carry.i, admm_iters=carry.k,
        res_pri=r.res_pri, res_dual=r.res_dual, rel_gap=r.rel_gap,
        pobj=r.ct_x_by_tau / tau[:, 0], dobj=r.bt_y_by_tau / tau[:, 0],
        u_raw=carry.u, v_raw=carry.v, mu=carry.mu, u_sum_raw=zl,
        v_sum_raw=zl, sj=zi)


def solve_lp_batch_coo(rows, cols, valss, bs, cs, *, m, n, eps=1e-6,
                       max_ipm=200, max_admm=100_000, alpha=1.8,
                       rho_y=1e-3, gamma0=2.0, sigma0=0.3,
                       hybrid_thresh=1000.0, dynamic_x=0.8,
                       dynamic_eta=1.1, shrink_second=0.5, cg_rate=2.0,
                       cg_max_iters=500, qres_period=64, probe_period=8,
                       device=None, info=None) -> DeviceSolveResult:
    """Solve a stacked batch of SAME-PATTERN sparse LPs on `device`
    (default: the CUDA card).

    rows/cols: the shared COO pattern (rows sorted ascending); valss:
    (B, nnz) per-lane values; bs: (B, m); cs: (B, n) -- numpy arrays or
    tensors.  Options and defaults are the reference's
    (`sparse_batched.py:296-322`).  `info`, where given, is a dict that
    receives `cg_iters`, each lane's total PCG iterations."""
    dev = resolve_device(device)
    pattern = SharedPattern.from_coo(rows, cols, m, n, device=dev)

    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=f64)
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    valss, bs, cs = t(valss), t(bs), t(cs)
    if valss.shape[1:] != (pattern.nnz,) or bs.shape[1:] != (m,) \
            or cs.shape[1:] != (n,):
        raise ValueError(f"need (B, {pattern.nnz}) values, (B, {m}) b and "
                         f"(B, {n}) c; got {tuple(valss.shape)}, "
                         f"{tuple(bs.shape)}, {tuple(cs.shape)}")
    return _solve_coo(pattern, valss, bs, cs, eps=eps, max_ipm=max_ipm,
                      max_admm=max_admm, alpha=alpha, rho_y=rho_y,
                      gamma0=gamma0, sigma0=sigma0,
                      hybrid_thresh=hybrid_thresh, dynamic_x=dynamic_x,
                      dynamic_eta=dynamic_eta, shrink_second=shrink_second,
                      cg_rate=cg_rate, cg_max_iters=cg_max_iters,
                      qres_period=qres_period, probe_period=probe_period,
                      info=info)
