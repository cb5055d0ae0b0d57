"""Restarted PDHG (PDLP-style) first-order LP and conic-LP solver.

Port of `abip_tpu/pdhg.py`: the native counterpart of the reference's
external PDLP driver (`scripts/bench-lp/pdlp_solve.py:1-146`), and with
`cones.cone_project` the conic competitor of `min c'x s.t. Ax = b,
x in K` (the SCS role of `scripts/bench-qcp/test_cblib.m:66-69`).
Quadratic objectives are out of scope (PDHG's x-step has no closed prox
for a coupled Q): `qcp.solve_qcp` covers them.

Algorithm (Applegate et al., NeurIPS 2021) on the saddle point
min_{x in K} max_y c'x + y'(b - Ax):

    x+ = Pi_K(x - tau (c - A'y))
    y+ = y  + sigma (b - A(2x+ - x))

with tau = eta/omega, sigma = eta*omega, eta = 0.9/||A||_2, Ruiz/pc
equilibration, adaptive restarts to the better of {current, average}
by KKT error, and primal-weight (omega) updates at each restart.

Lanes first: every instance is a row of `(B, ...)` tensors.  The
reference's `while_loop` of trips is a host loop: a trip of
`check_period` steps is issued with no read, then the f64 KKT check, the
infeasibility and unboundedness certificates, the restart and the
primal-weight update run on every lane, and the host reads once a trip
whether any lane continues.  A lane that has stopped is frozen by mask,
so lane b of a batch equals the one-lane solve.  `precision="mixed"`
runs each step's two products as the f64 product at the trip's anchor
plus an f32 delta product (IEEE f32, `device.ieee_f32`); the checks
stay f64.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .cones import ConeLayout, cone_operands, cone_project
from .device import ieee_f32, resolve_device
from .lp import LPSolution
from .ops.admm_delta import _mv, _rmv
from .parallel.batched import _NOT_PORTED, _select
from .scaling import equilibrate, equilibrate_conic
from .settings import Status

f32 = torch.float32
f64 = torch.float64


class _ScaleFlags(NamedTuple):
    """Minimal settings shim for `scaling.equilibrate`."""

    pc_ruiz_rescale: bool = True
    origin_rescale: bool = True
    qp_rescale: bool = False
    ruiz_iter: int = 10
    scale: float = 1.0


def estimate_spectral_norm(A, iters: int = 40):
    """||A||_2 of each lane of a `(B, m, n)` stack (or of one `(m, n)`
    matrix) by power iteration on A'A."""
    one = A.dim() == 2
    A = A[None] if one else A
    n = A.shape[-1]
    v = torch.ones(A.shape[:1] + (n,), dtype=A.dtype, device=A.device) / \
        torch.sqrt(torch.tensor(float(n), dtype=A.dtype, device=A.device))
    for _ in range(iters):
        w = _rmv(A, _mv(A, v))
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1),
                            min=1e-30)[:, None]
    out = torch.linalg.vector_norm(_mv(A, v), dim=-1)
    return out[0] if one else out


class PDHGState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    x_sum: torch.Tensor
    y_sum: torch.Tensor
    n_avg: torch.Tensor          # iterations accumulated in the average
    x_rs: torch.Tensor           # iterate at the last restart (scaled)
    y_rs: torch.Tensor
    err_rs: torch.Tensor         # KKT error at the last restart
    x_cand: torch.Tensor         # candidate whose residuals are reported
    y_cand: torch.Tensor
    omega: torch.Tensor          # primal weight
    k: torch.Tensor              # total PDHG iterations
    status: torch.Tensor
    pres: torch.Tensor
    dres: torch.Tensor
    gap: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    res_infeas: torch.Tensor
    res_unbdd: torch.Tensor


def _kkt_unscaled(A, b, c, E, D, xb, yb, nb, nc, layout=None, co=None,
                  rho_b=1.0, rho_c=1.0):
    """Unscaled relative KKT residuals of scaled iterates (xb, yb), per
    lane (`pdhg.py:93-120`): x = xb/(E rho_b), y = yb/(D rho_c), s =
    c - A'y; dual infeasibility is the negative part of s (orthant) or
    its distance to the dual cone."""
    x = xb / (E * _col(rho_b))
    y = yb / (D * _col(rho_c))
    r_pri = _mv(A, x) - b
    s = c - _rmv(A, y)
    if layout is None:
        dviol = torch.clamp(s, max=0.0)
    else:
        dviol = s - cone_project(s, layout, dual=True, co=co)
    pres = torch.linalg.vector_norm(r_pri, dim=-1) / (1.0 + nb)
    dres = torch.linalg.vector_norm(dviol, dim=-1) / (1.0 + nc)
    pobj = (c * x).sum(-1)
    dobj = (b * y).sum(-1)
    gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
    return pres, dres, gap, pobj, dobj


def _col(v):
    """A per-lane `(B,)` tensor as a `(B, 1)` column; floats pass."""
    return v[:, None] if isinstance(v, torch.Tensor) else v


def _pdhg_run(Ab, bb, cb, A, b, c, E, D, eta, omega0, eps, max_iters,
              check_period, precision="f64", cones=None, rho_b=1.0,
              rho_c=1.0) -> PDHGState:
    """The restarted loop (`pdhg.py:123-341`) on `(B, ...)` lanes."""
    B, m, n = Ab.shape
    dt = Ab.dtype
    dev = Ab.device
    nb = torch.linalg.vector_norm(b, dim=-1)
    nc = torch.linalg.vector_norm(c, dim=-1)
    mixed = precision == "mixed"
    A32 = Ab.to(f32).contiguous() if mixed else None
    layout = ConeLayout(cones) if cones is not None else None
    co = cone_operands(cones, dev) if cones is not None else None

    def proj(v):
        if layout is None:
            return torch.clamp(v, min=0.0)
        return cone_project(v, layout, co=co)

    def sprint(x, y, omega):
        """check_period steps at fixed (tau, sigma); returns the sums."""
        tau = _col(eta / omega)
        sigma = _col(eta * omega)
        xs, ys = torch.zeros_like(x), torch.zeros_like(y)
        if mixed:
            x_a, y_a = x, y
            Ax_a = _mv(Ab, x_a)         # f64 anchor products, once a trip
            ATy_a = _rmv(Ab, y_a)
            for _ in range(check_period):
                ATy = ATy_a + _rmv(A32, (y - y_a).to(f32)).to(dt)
                xn = proj(x - tau * (cb - ATy))
                z = 2.0 * xn - x
                Az = Ax_a + _mv(A32, (z - x_a).to(f32)).to(dt)
                x, y = xn, y + sigma * (bb - Az)
                xs, ys = xs + x, ys + y
        else:
            for _ in range(check_period):
                xn = proj(x - tau * (cb - _rmv(Ab, y)))
                x, y = xn, y + sigma * (bb - _mv(Ab, 2.0 * xn - x))
                xs, ys = xs + x, ys + y
        return x, y, xs, ys

    def body(st: PDHGState) -> PDHGState:
        x, y, xs, ys = sprint(st.x, st.y, st.omega)
        x_sum, y_sum = st.x_sum + xs, st.y_sum + ys
        n_avg = st.n_avg + check_period
        x_avg = x_sum / n_avg[:, None]
        y_avg = y_sum / n_avg[:, None]

        cur = _kkt_unscaled(A, b, c, E, D, x, y, nb, nc, layout, co,
                            rho_b, rho_c)
        avg = _kkt_unscaled(A, b, c, E, D, x_avg, y_avg, nb, nc, layout, co,
                            rho_b, rho_c)
        cur_err = torch.maximum(torch.maximum(cur[0], cur[1]), cur[2])
        avg_err = torch.maximum(torch.maximum(avg[0], avg[1]), avg[2])

        take_avg = avg_err < cur_err
        ta = take_avg[:, None]
        x_c = torch.where(ta, x_avg, x)
        y_c = torch.where(ta, y_avg, y)
        pres, dres, gap, pobj, dobj = (torch.where(take_avg, a, b_)
                                       for a, b_ in zip(avg, cur))
        cand_err = torch.minimum(avg_err, cur_err)
        k = st.k + check_period

        converged = (pres < eps) & (dres < eps) & (gap < eps)
        status = torch.where(converged, Status.SOLVED, st.status)

        # certificates from the movement since the last restart (PDLP's
        # infimal-displacement test; `abip.c:1565-1576`), unscaled rays
        eps_inf = 1e-7
        dyu = (y - st.y_rs) / D
        ny = torch.linalg.vector_norm(dyu, dim=-1)
        yhat = dyu / torch.clamp(ny, min=1e-30)[:, None]
        by = (b * yhat).sum(-1)
        # Farkas: A'yhat in -K*, violation ||w + Pi_K*(-w)||
        w = _rmv(A, yhat)
        if layout is None:
            inf_viol = torch.clamp(w, min=0.0)
        else:
            inf_viol = w + cone_project(-w, layout, dual=True, co=co)
        infeas_err = torch.linalg.vector_norm(inf_viol, dim=-1) / \
            torch.clamp(by, min=1e-30)
        inf_t = torch.full_like(ny, torch.inf)
        res_infeas = torch.where((ny > 1e-30) & (by > 0.0), infeas_err,
                                 inf_t)

        dxu = proj((x - st.x_rs) / E)
        nx = torch.linalg.vector_norm(dxu, dim=-1)
        xhat = dxu / torch.clamp(nx, min=1e-30)[:, None]
        cx = (c * xhat).sum(-1)
        unbdd_err = torch.linalg.vector_norm(_mv(A, xhat), dim=-1) / \
            torch.clamp(-cx, min=1e-30)
        res_unbdd = torch.where((nx > 1e-30) & (cx < 0.0), unbdd_err, inf_t)

        status = torch.where((status == Status.UNFINISHED)
                             & (res_infeas < eps_inf),
                             Status.INFEASIBLE, status)
        status = torch.where((status == Status.UNFINISHED)
                             & (res_unbdd < eps_inf),
                             Status.UNBOUNDED, status)

        # PDLP's practical restart rule (beta=0.2, or the averaging window
        # past 0.36 of the iterations); convergence forces the restart so
        # the reported residuals belong to the adopted candidate
        restart = (cand_err <= 0.2 * st.err_rs) | (n_avg >= 0.36 * k.to(dt)) \
            | converged

        # primal weight from the movement since the last restart,
        # smoothed (theta=0.5) and rate-limited to 4x per restart
        dx = torch.linalg.vector_norm(x_c - st.x_rs, dim=-1)
        dy = torch.linalg.vector_norm(y_c - st.y_rs, dim=-1)
        safe = (dx > 1e-30) & (dy > 1e-30)
        one = torch.ones_like(dx)
        log_ratio = torch.where(
            safe, torch.log(torch.where(safe, dy, one))
            - torch.log(torch.where(safe, dx, one)), torch.zeros_like(dx))
        log_w = torch.log(st.omega)
        l4 = float(np.log(4.0))
        step_lw = torch.clamp(0.5 * (log_ratio - log_w), -l4, l4)
        omega_new = torch.clamp(torch.exp(log_w + step_lw), 1e-4, 1e4)
        omega = torch.where(restart & safe, omega_new, st.omega)

        rs = restart[:, None]
        return PDHGState(
            x=torch.where(rs, x_c, x), y=torch.where(rs, y_c, y),
            x_sum=torch.where(rs, torch.zeros_like(x), x_sum),
            y_sum=torch.where(rs, torch.zeros_like(y), y_sum),
            n_avg=torch.where(restart, torch.zeros_like(n_avg), n_avg),
            x_rs=torch.where(rs, x_c, st.x_rs),
            y_rs=torch.where(rs, y_c, st.y_rs),
            err_rs=torch.where(restart, cand_err, st.err_rs),
            x_cand=x_c, y_cand=y_c, omega=omega, k=k,
            status=status.to(torch.int32), pres=pres, dres=dres, gap=gap,
            pobj=pobj, dobj=dobj, res_infeas=res_infeas,
            res_unbdd=res_unbdd)

    zero = torch.zeros((B,), dtype=dt, device=dev)
    inf = torch.full((B,), torch.inf, dtype=dt, device=dev)
    zx = torch.zeros((B, n), dtype=dt, device=dev)
    zy = torch.zeros((B, m), dtype=dt, device=dev)
    st = PDHGState(
        x=zx, y=zy, x_sum=zx, y_sum=zy, n_avg=zero, x_rs=zx, y_rs=zy,
        err_rs=inf, x_cand=zx, y_cand=zy,
        omega=torch.as_tensor(omega0, dtype=dt, device=dev).expand(B),
        k=torch.zeros((B,), dtype=torch.int32, device=dev),
        status=torch.full((B,), Status.UNFINISHED, dtype=torch.int32,
                          device=dev),
        pres=inf, dres=inf, gap=inf, pobj=zero, dobj=zero,
        res_infeas=inf, res_unbdd=inf)
    with ieee_f32():
        while True:
            alive = (st.status == Status.UNFINISHED) & (st.k < max_iters)
            if not bool(alive.any()):
                break
            st = _select(alive, body(st), st)
    return st


def _stepsize(Ab, bb, cb):
    """eta = 0.9/||A||_2 and the primal weight's start ||c||/||b||."""
    eta = 0.9 / torch.clamp(estimate_spectral_norm(Ab), min=1e-30)
    nbb = torch.linalg.vector_norm(bb, dim=-1)
    ncb = torch.linalg.vector_norm(cb, dim=-1)
    omega0 = torch.where((nbb > 1e-30) & (ncb > 1e-30), ncb / nbb,
                         torch.ones_like(nbb))
    return eta, omega0


def _setup(A, b, c):
    """LP setup (`pdhg.py:344-357`) on `(B, ...)` lanes; returns the
    positional arguments of `_pdhg_run` up to (eta, omega0)."""
    Ab, sd = equilibrate(A, _ScaleFlags())
    bb = b / sd.D
    cb = c / sd.E
    return (Ab, bb, cb, A, b, c, sd.E, sd.D) + _stepsize(Ab, bb, cb)


def _setup_conic(A, b, c, cones):
    """Conic setup (`pdhg.py:360-375`): cone-tied equilibration, stepsize
    and primal weight.  Returns the `_pdhg_run` arguments and
    (rho_b, rho_c)."""
    Ab, _Q, bb, cb, sd = equilibrate_conic(A, None, b, c, ConeLayout(cones),
                                           _ScaleFlags())
    return ((Ab, bb, cb, A, b, c, sd.E, sd.D) + _stepsize(Ab, bb, cb),
            (sd.sc_b, sd.sc_c))


def _check_precision(precision):
    if precision not in ("f64", "mixed"):
        raise ValueError(f"precision must be 'f64' or 'mixed'; "
                         f"got {precision!r}")


def _lanes(dev, *xs):
    return tuple(torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)
                 if not isinstance(x, torch.Tensor)
                 else x.to(device=dev, dtype=f64) for x in xs)


def _final_status(st: PDHGState):
    """Status of lane 0 with the reference's UNFINISHED mapping
    (`pdhg.py:405-408`)."""
    head = torch.stack([st.status[0].to(f64), st.pres[0], st.dres[0],
                        st.gap[0], st.pobj[0], st.dobj[0], st.res_infeas[0],
                        st.res_unbdd[0], st.k[0].to(f64)]).tolist()
    status = int(head[0])
    if status == Status.UNFINISHED:
        worst = max(head[1:4])
        status = Status.SOLVED_INACCURATE if worst < 1e-3 else Status.FAILED
    return status, head


def solve_lp_pdhg(A, b, c, eps: float = 1e-6, max_iters: int = 200_000,
                  check_period: int = 256, precision: str = "f64",
                  device=None) -> LPSolution:
    """Solve `min c'x s.t. Ax = b, x >= 0` with restarted PDHG on
    `device` (default: the CUDA card).  The returned `LPSolution` reports
    PDHG iterations in `admm_iters` and the candidate iterate whose
    residuals it reports, on every exit path."""
    _check_precision(precision)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    A, b, c = _lanes(dev, A, b, c)
    run_args = _setup(A[None], b[None], c[None])
    sd_E, sd_D = run_args[6], run_args[7]
    setup = time.perf_counter() - t0
    t1 = time.perf_counter()
    st = _pdhg_run(*run_args, eps, max_iters, check_period,
                   precision=precision)
    status, head = _final_status(st)
    y = st.y_cand / sd_D
    s = c[None] - _rmv(A[None], y)
    x = (st.x_cand / sd_E)[0].cpu().numpy()
    solve = time.perf_counter() - t1
    return LPSolution(
        x=x, y=y[0].cpu().numpy(), s=s[0].cpu().numpy(), status=status,
        status_name=Status.name(status), pobj=head[4], dobj=head[5],
        res_pri=head[1], res_dual=head[2], rel_gap=head[3],
        res_infeas=head[6], res_unbdd=head[7], ipm_iters=0,
        admm_iters=int(head[8]), setup_time=setup, solve_time=solve)


def solve_qcp_pdhg(A, b, c, cones, eps: float = 1e-6,
                   max_iters: int = 200_000, check_period: int = 256,
                   precision: str = "f64", device=None):
    """Solve `min c'x s.t. Ax = b, x in K` with restarted PDHG on
    `device` (default: the CUDA card): `solve_lp_pdhg`'s loop with
    `cone_project` in the x-update and dual-cone distances in the
    residuals and certificates.  Q is not supported."""
    from .qcp import ConicSolution

    _check_precision(precision)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    A, b, c = _lanes(dev, A, b, c)
    cones.validate_dim(A.shape[1])
    run_args, (sc_b, sc_c) = _setup_conic(A[None], b[None], c[None], cones)
    sd_E, sd_D = run_args[6], run_args[7]
    setup = time.perf_counter() - t0
    t1 = time.perf_counter()
    st = _pdhg_run(*run_args, eps, max_iters, check_period,
                   precision=precision, cones=cones, rho_b=sc_b, rho_c=sc_c)
    status, head = _final_status(st)
    x = st.x_cand / (sd_E * sc_b[:, None])
    y = st.y_cand / (sd_D * sc_c[:, None])
    s = c[None] - _rmv(A[None], y)
    solve = time.perf_counter() - t1
    return ConicSolution(
        x=x[0].cpu().numpy(), y=y[0].cpu().numpy(), s=s[0].cpu().numpy(),
        status=status, status_name=Status.name(status), pobj=head[4],
        dobj=head[5], res_pri=head[1], res_dual=head[2], rel_gap=head[3],
        res_infeas=head[6], res_unbdd=head[7], ipm_iters=0,
        admm_iters=int(head[8]), setup_time=setup, solve_time=solve)


def solve_lp_pdhg_batch(As, bs, cs, eps: float = 1e-6,
                        max_iters: int = 200_000, check_period: int = 256,
                        precision: str = "mixed", mesh=None,
                        device=None) -> PDHGState:
    """Solve a stacked batch of same-shape LPs with restarted PDHG on
    `device` (default: the CUDA card).  As: (B, m, n); bs: (B, m); cs:
    (B, n).  Returns the final `PDHGState` (fields lead with the lane
    axis); `status == 1` marks solved lanes."""
    if mesh is not None:
        raise NotImplementedError("mesh sharding " + _NOT_PORTED.format(19))
    _check_precision(precision)
    dev = resolve_device(device)
    As, bs, cs = _lanes(dev, As, bs, cs)
    return _pdhg_run(*_setup(As, bs, cs), eps, max_iters, check_period,
                     precision=precision)


def solve_qcp_pdhg_batch(As, bs, cs, cones, eps: float = 1e-6,
                         max_iters: int = 200_000, check_period: int = 256,
                         precision: str = "mixed", mesh=None,
                         device=None) -> PDHGState:
    """Batched conic PDHG: a stacked batch of same-shape, same-cone
    problems on `device` (default: the CUDA card).  Returns the final
    `PDHGState`."""
    if mesh is not None:
        raise NotImplementedError("mesh sharding " + _NOT_PORTED.format(19))
    _check_precision(precision)
    dev = resolve_device(device)
    As, bs, cs = _lanes(dev, As, bs, cs)
    run_args, (sc_b, sc_c) = _setup_conic(As, bs, cs, cones)
    return _pdhg_run(*run_args, eps, max_iters, check_period,
                     precision=precision, cones=cones, rho_b=sc_b,
                     rho_c=sc_c)
