"""Batched conic solver: the two-phase sprint2 path, lanes on one device.

Port of the `engine="sprint2"` path of `abip_tpu/parallel/batched_qcp.py`
(`phase1="ladder"`, `endgame="delta"`, `compact_period=0`).  Every
instance is a lane: a row of `(B, ...)` tensors sharing one `ConeSpec`.
The outer barrier loop and the chunk loop run on the host; a lane whose
loop condition is false is frozen by mask, exactly as a vmapped
`while_loop` freezes it, so each lane's result equals a one-lane solve
of the same instance.

Per lane:

* setup, once (`prepare_conic_batch`, f64): the cone-tied equilibration,
  the Newton-inverse Schur factors (Woodbury form when 2m <= n), and the
  tau-quadratic precompute r_vec, a_coef;
* phase 1 (`engine="ladder"`): launches of the ladder
  (`ops.conic_dr.fused_dr_ladder`, kernel K2 on the card) of
  T = max(2048, inner_crit_period) f32 iterations, each followed by one
  f64 residual check, until mu < sprint_mu_switch;
* phase 2 (`engine="delta"`), resumed from phase 1's state: barrier
  stages of anchored-delta chunks (`ops.conic_delta.run_conic_delta_chunk`,
  kernel K3 on the card), each chunk followed by the f64 residuals and
  the f64 inner criterion; between stages `adjust_barrier_device`, with
  the last-resort stage budget max(16384, 8*T), its mu floor and the
  two-stall stagnation exit;
* extraction: unscale; lanes that finished in phase 1 keep phase 1's
  result.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import conic_ops
from ..cones import ConeLayout, ConeSpec, cone_operands
from ..linsys.schur import DenseSchurSolver
from ..ops.admm_delta import _mv, _rmv
from ..ops.conic_delta import run_conic_delta_chunk
from ..ops.conic_dr import fused_dr_ladder
from ..qcp import conic_defaults
from ..scaling import equilibrate_conic
from .batched import _as_f64, _select

f32 = torch.float32
f64 = torch.float64
i32 = torch.int32

_NOT_PORTED = "is not ported to abip_tpu_torch yet (ROADMAP.md queue 1, item {})"


class ConicDeviceResult(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    status: torch.Tensor       # int32: 1 solved, -1 unbounded, -2 infeasible, 2 stalled, 0 unfinished
    ipm_iters: torch.Tensor
    admm_iters: torch.Tensor
    res_pri: torch.Tensor
    res_dual: torch.Tensor
    rel_gap: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    # raw internal state (scaled space) for the phase hand-off
    u_raw: torch.Tensor
    v_raw: torch.Tensor
    mu: torch.Tensor
    tol_inner: torch.Tensor


class PreparedConic(NamedTuple):
    """Per-lane setup: equilibrated data, Schur factors and the
    tau-quadratic precompute (`pre_calculate`, `source/abip.c:886-910`)."""

    A: torch.Tensor          # (B, m, n) scaled
    b: torch.Tensor
    c: torch.Tensor
    Q_diag: torch.Tensor     # (B, n) scaled, or None
    D: torch.Tensor
    E: torch.Tensor
    sc_b: torch.Tensor       # (B,)
    sc_c: torch.Tensor
    nm_inf_b0: torch.Tensor  # inf-norms of the ORIGINAL data
    nm_inf_c0: torch.Tensor
    dss: DenseSchurSolver
    r_vec: torch.Tensor      # (B, m + n) K^-1(-b; c)
    a_coef: torch.Tensor     # (B,)


def prepare_conic_batch(As, bs, cs, Q_diags=None, *, cones: ConeSpec,
                        rho_y=1e-6, rho_x=1.0, rho_tau=1.0,
                        precision="mixed", form="auto",
                        normalize=True) -> PreparedConic:
    """The per-lane setup, once (`batched_qcp.prepare_conic_batch`):
    equilibration, Newton-inverse Schur factors (mode "newton", the
    mixed-precision factors) and the tau-quadratic precompute."""
    if precision != "mixed":
        raise NotImplementedError(f"precision={precision!r} "
                                  + _NOT_PORTED.format(11))
    B, m, n = As.shape
    layout = ConeLayout(cones)
    layout.spec.validate_dim(n)
    nm_b = (torch.abs(bs).amax(-1) if m
            else torch.zeros((B,), dtype=As.dtype, device=As.device))
    nm_c = torch.abs(cs).amax(-1)
    if normalize:
        A2, Q2, b2, c2, scal = equilibrate_conic(As, Q_diags, bs, cs, layout,
                                                 conic_defaults())
        D, E, sc_b, sc_c = scal
    else:
        A2, Q2, b2, c2 = As, Q_diags, bs, cs
        D = torch.ones((B, m), dtype=As.dtype, device=As.device)
        E = torch.ones((B, n), dtype=As.dtype, device=As.device)
        sc_b = torch.ones((B,), dtype=As.dtype, device=As.device)
        sc_c = torch.ones_like(sc_b)
    woodbury = (2 * m <= n) if form == "auto" else form == "woodbury"
    rho_yv = torch.full((m,), rho_y, dtype=As.dtype, device=As.device)
    rho_xv = torch.full((n,), rho_x, dtype=As.dtype, device=As.device)
    dss = DenseSchurSolver(A2, Q2, rho_yv, rho_xv, mode="newton",
                           form="woodbury" if woodbury else "primal")
    r_y, r_x = dss.solve(-b2, c2)
    r_vec = torch.cat([r_y, r_x], dim=1)
    rho_vec = torch.cat([rho_yv, rho_xv])
    a_coef = rho_tau + (rho_vec * r_vec * r_vec).sum(-1)
    return PreparedConic(A=A2, b=b2, c=c2, Q_diag=Q2, D=D, E=E, sc_b=sc_b,
                         sc_c=sc_c, nm_inf_b0=nm_b, nm_inf_c0=nm_c, dss=dss,
                         r_vec=r_vec, a_coef=a_coef)


def prepared_from_numpy(prep, device=None) -> PreparedConic:
    """The reference's `PreparedConic` (after `jax.device_get`: numpy
    leaves, batched, its `DenseSchurSolver` in mode "newton") as the
    port's."""
    def t(x):
        return None if x is None else torch.from_numpy(
            np.array(x, dtype=np.float64)).to(device)

    return PreparedConic(
        A=t(prep.A), b=t(prep.b), c=t(prep.c), Q_diag=t(prep.Q_diag),
        D=t(prep.D), E=t(prep.E), sc_b=t(prep.sc_b), sc_c=t(prep.sc_c),
        nm_inf_b0=t(prep.nm_inf_b0), nm_inf_c0=t(prep.nm_inf_c0),
        dss=DenseSchurSolver.from_numpy(prep.dss, device),
        r_vec=t(prep.r_vec), a_coef=t(prep.a_coef))


class _Inner(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    v_origin: torch.Tensor
    j: torch.Tensor
    k: torch.Tensor
    err_inner: torch.Tensor
    status: torch.Tensor
    res: conic_ops.ConicResiduals


class _Outer(NamedTuple):
    inner: _Inner
    mu: torch.Tensor
    tol_inner: torch.Tensor
    i: torch.Tensor
    # consecutive stages that stalled AT the mu floor; two in a row end
    # the solve with the stagnation code
    stall: torch.Tensor


def _device_solve_qcp(P: PreparedConic, cones: ConeSpec, *, engine, eps,
                      max_ipm, max_admm, alpha, rho_y, rho_x, rho_tau, psi,
                      inner_crit_period, probe_period, sprint_mu_switch,
                      mu_stop, init_state) -> ConicDeviceResult:
    """`_device_solve_qcp` for engine "ladder" or "delta" (precision
    "mixed", cadence "chunk"), every lane at once."""
    if inner_crit_period < 1 or probe_period < 1:
        raise ValueError("inner_crit_period and probe_period must be >= 1; "
                         f"got {inner_crit_period}, {probe_period}")
    if engine == "delta" and init_state is None:
        # the conic delta chunk does NOT implement the first-iteration
        # tau_t := 1 case (`source/abip.c:186-254`): it is an ENDGAME
        raise ValueError(
            "engine='delta' is an endgame: pass init_state from a prior "
            "phase (cold start lacks the k=0 tau_t=1 case)")
    if engine == "ladder" and not (mu_stop and mu_stop >= sprint_mu_switch):
        raise ValueError("engine='ladder' runs phase-1 style: pass "
                         "mu_stop >= sprint_mu_switch")
    layout = ConeLayout(cones)
    A, b, c, Qd = P.A, P.b, P.c, P.Q_diag
    B, m, n = A.shape
    l = m + n + 1
    dev = A.device
    dss = P.dss
    woodbury = dss.form == "woodbury"
    co = cone_operands(cones, dev)
    rho = torch.cat([torch.full((m,), rho_y, dtype=f64, device=dev),
                     torch.full((n,), rho_x, dtype=f64, device=dev),
                     torch.full((1,), rho_tau, dtype=f64, device=dev)])
    probe = min(probe_period, inner_crit_period)
    kcap = max_admm

    def Q_times(x):
        return torch.zeros_like(x) if Qd is None else Qd * x

    def mv64(x):
        return _mv(A, x)

    def rmv64(y):
        return _rmv(A, y)

    def residuals(u, v_origin, prev):
        return conic_ops.conic_residuals(
            u, v_origin, prev, mv64, rmv64, Q_times, b, c, P.D, P.E,
            P.sc_b, P.sc_c, 1.0, P.nm_inf_b0, P.nm_inf_c0, eps, eps, eps,
            m, n)

    def converged(r, total_pos):
        return conic_ops.conic_converged_code(r, eps, eps, eps, eps, eps,
                                              0.0, total_pos)

    A32 = A.to(f32).contiguous()
    Minv32 = dss.Minv64.to(f32).contiguous()
    Hinv32 = (dss.H_inv.to(f32) if woodbury
              else torch.zeros((B, n), dtype=f32, device=dev))
    Qd32 = (Qd.to(f32) if Qd is not None
            else torch.zeros((B, n), dtype=f32, device=dev))

    def ladder_body(o: _Outer, alive) -> _Outer:
        """The WHOLE barrier ladder in one launch per lane, then one f64
        residual/status pass; a T-cap exit returns with mu still
        >= mu_stop and the outer loop re-enters."""
        s = o.inner
        u, v, t_done, err, mu2, tol2, stages = fused_dr_ladder(
            A32, Minv32, Hinv32, P.r_vec.to(f32), b.to(f32), c.to(f32),
            Qd32, P.D.to(f32), P.E.to(f32), co, rho_y, rho_x, rho_tau,
            P.a_coef, o.mu, o.tol_inner, mu_stop, eps, P.sc_b, P.sc_c,
            P.nm_inf_b0, P.nm_inf_c0, alpha, s.u.to(f32), s.v.to(f32),
            s.k.to(f32), T=max(2048, inner_crit_period), probe=probe,
            psi=float(psi), woodbury=woodbury, active=alive)
        u, v = u.to(f64), v.to(f64)
        v_origin = rho * v
        k = s.k + t_done
        r = residuals(u, v_origin, s.res)
        st = converged(r, (o.i > 0) & (k > 0))
        inner = _Inner(u=u, v=v, v_origin=v_origin, j=t_done, k=k,
                       err_inner=err.to(f64), status=st, res=r)
        return _Outer(inner=inner, mu=mu2.to(f64), tol_inner=tol2.to(f64),
                      i=o.i + stages, stall=torch.zeros_like(o.stall))

    # the last-resort stage budget: the f32 criterion floors at
    # ~sqrt(q)*eps32, so a stage whose tolerance drops below it could
    # never end; floored at 16384 so legitimate hard stages are untouched
    stage_budget = max(16384, 8 * inner_crit_period)

    def delta_chunk(s: _Inner, o: _Outer, act) -> _Inner:
        """One anchored-delta chunk, then the f64 residual/status check
        and the f64-authoritative inner criterion."""
        res_d = run_conic_delta_chunk(
            A, dss.solve, Qd, P.r_vec[:, :m], P.r_vec[:, m:], b, c, P.a_coef,
            rho_y, rho_x, rho_tau, o.mu, alpha, o.tol_inner, s.u, s.v,
            s.err_inner, layout, co, A32, Minv32, Hinv32, woodbury,
            T=inner_crit_period, probe=probe, active=act)
        v_origin = rho * res_d.v
        k = s.k + res_d.t_done
        r = residuals(res_d.u, v_origin, s.res)
        st = converged(r, (o.i > 0) & (k > 0))
        err64 = conic_ops.inner_conv_check(res_d.u, v_origin, mv64, rmv64,
                                           Q_times, b, c, m, n)
        return _Inner(u=res_d.u, v=res_d.v, v_origin=v_origin,
                      j=s.j + res_d.t_done, k=k, err_inner=err64, status=st,
                      res=r)

    def delta_body(o: _Outer, alive) -> _Outer:
        s = o.inner._replace(
            j=torch.zeros((B,), dtype=i32, device=dev),
            err_inner=torch.full((B,), float("inf"), dtype=f64, device=dev),
            status=torch.zeros((B,), dtype=i32, device=dev))
        while True:
            act = (alive & (s.err_inner >= o.tol_inner) & (s.status == 0)
                   & (s.k < kcap) & (s.j < stage_budget))
            if not bool(act.any()):
                break
            s = _select(act, delta_chunk(s, o, act), s)
        r = residuals(s.u, s.v_origin, s.res)
        st = torch.where(s.status != 0, s.status,
                         converged(r, (o.i > 0) & (s.k > 0)))
        mu, tol = conic_ops.adjust_barrier_device(o.mu, r.error_ratio, eps,
                                                  psi)
        done = st != 0
        stalled = s.j >= stage_budget
        cap_exit = (s.err_inner >= o.tol_inner) & ~stalled
        # mu floor for stall-advances: lower mu underflows the f32
        # barrier weight; at the floor a stalled stage keeps mu and
        # counts toward the stagnation exit
        at_floor = stalled & (o.mu <= eps * 1e-3)
        mu = torch.where(done | cap_exit | at_floor, o.mu, mu)
        tol = torch.where(cap_exit | at_floor, o.tol_inner, tol)
        stall = torch.where(at_floor, o.stall + 1, 0).to(i32)
        st = torch.where((st == 0) & (stall >= 2), 2, st).to(i32)
        return _Outer(inner=s._replace(res=r, status=st), mu=mu,
                      tol_inner=tol,
                      i=o.i + torch.where(cap_exit, 0, 1).to(i32),
                      stall=stall)

    zi = torch.zeros((B,), dtype=i32, device=dev)
    res0 = conic_ops.ConicResiduals.init(B, f64, dev)
    if init_state is None:
        x0 = layout.interior_point(f64, dev).expand(B, n)
        u0 = torch.cat([torch.zeros((B, m), dtype=f64, device=dev), x0,
                        torch.ones((B, 1), dtype=f64, device=dev)], dim=1)
        o = _Outer(
            inner=_Inner(u=u0, v=u0.clone(), v_origin=rho * u0, j=zi, k=zi,
                         err_inner=torch.full((B,), float("inf"), dtype=f64,
                                              device=dev),
                         status=zi, res=res0),
            mu=torch.ones((B,), dtype=f64, device=dev),
            tol_inner=torch.full((B,), 4.0, dtype=f64, device=dev), i=zi,
            stall=zi)
    else:
        # phase hand-off resume: (u, v, mu, tol_inner, k, i, status)
        u_i, v_i, mu_i, tol_i, k_i, i_i, st_i = init_state
        v_i = v_i.to(f64)
        o = _Outer(
            inner=_Inner(u=u_i.to(f64), v=v_i, v_origin=rho * v_i, j=zi,
                         k=k_i.to(i32),
                         err_inner=torch.full((B,), float("inf"), dtype=f64,
                                              device=dev),
                         status=st_i.to(i32), res=res0),
            mu=mu_i.to(f64), tol_inner=tol_i.to(f64), i=i_i.to(i32),
            stall=zi)

    body = ladder_body if engine == "ladder" else delta_body
    while True:
        alive = (o.inner.status == 0) & (o.i < max_ipm) & (o.inner.k < kcap)
        if mu_stop > 0.0:
            # phase-boundary exit: stop with status 0 once the barrier
            # passes mu_stop, so the next phase continues
            alive = alive & (o.mu >= mu_stop)
        if not bool(alive.any()):
            break
        o = _select(alive, body(o, alive), o)

    s, r = o.inner, o.inner.res
    tau = torch.clamp(r.tau, min=conic_ops.EPS_TOL)[:, None]
    return ConicDeviceResult(
        x=s.u[:, m:m + n] / tau / (P.E * P.sc_b[:, None]),
        y=s.u[:, :m] / tau / (P.D * P.sc_c[:, None]),
        s=s.v[:, m:m + n] / tau * P.E / P.sc_c[:, None],
        status=s.status, ipm_iters=o.i, admm_iters=s.k,
        res_pri=r.res_pri, res_dual=r.res_dual, rel_gap=r.rel_gap,
        pobj=r.pobj, dobj=r.dobj, u_raw=s.u, v_raw=s.v, mu=o.mu,
        tol_inner=o.tol_inner)


def _check_options(precision, cadence, solver, engine, k_cap, Q_diags):
    if precision == "f64":
        raise NotImplementedError("precision='f64' " + _NOT_PORTED.format(11))
    if precision != "mixed":
        raise ValueError(f"precision must be 'f64' or 'mixed'; got "
                         f"{precision!r}")
    if cadence != "chunk":
        raise ValueError(f"engine={engine!r} requires cadence='chunk'")
    if solver not in ("cholesky", "inverse"):
        raise ValueError(f"unknown solver {solver!r}")
    if k_cap is not None:
        raise NotImplementedError("k_cap (straggler compaction) "
                                  + _NOT_PORTED.format(11))
    if Q_diags is not None and Q_diags.dim() == 3:
        raise NotImplementedError("a full (n, n) Q " + _NOT_PORTED.format(11))


def _solve(As, bs, cs, Q_diags, *, cones, engine, eps=1e-4, max_ipm=200,
           max_admm=100_000, alpha=1.8, rho_y=1e-6, rho_x=1.0, rho_tau=1.0,
           psi=1.0, precision="f64", inner_crit_period=1, solver="cholesky",
           normalize=False, form="auto", cadence="chunk", probe_period=8,
           sprint_mu_switch=1e-3, mu_stop=0.0, init_state=None, k_cap=None,
           prepared=None) -> ConicDeviceResult:
    """One program of the reference's `_solve_qcp_batch_jit`, for engine
    "ladder" or "delta".  The knobs of the steps engine
    (`inner_check_period`, `ir_steps`, `anchor_period`) come with it
    (ROADMAP.md queue 1, item 11); `solver`, which the reference's
    callers pass, does not act on these engines there either."""
    if engine in ("steps", "sprint"):
        raise NotImplementedError(f"engine={engine!r} "
                                  + _NOT_PORTED.format(11))
    if engine not in ("ladder", "delta"):
        raise ValueError(f"engine must be 'steps', 'sprint', 'ladder', or "
                         f"'delta'; got {engine!r}")
    _check_options(precision, cadence, solver, engine, k_cap, Q_diags)
    if prepared is None:
        prepared = prepare_conic_batch(
            As, bs, cs, Q_diags, cones=cones, rho_y=rho_y, rho_x=rho_x,
            rho_tau=rho_tau, precision=precision, form=form,
            normalize=normalize)
    elif normalize:
        raise ValueError("prepared already carries the scaling; do not also "
                         "pass normalize=True")
    return _device_solve_qcp(
        prepared, cones, engine=engine, eps=eps, max_ipm=max_ipm,
        max_admm=max_admm, alpha=alpha, rho_y=rho_y, rho_x=rho_x,
        rho_tau=rho_tau, psi=psi, inner_crit_period=inner_crit_period,
        probe_period=probe_period, sprint_mu_switch=sprint_mu_switch,
        mu_stop=mu_stop, init_state=init_state)


def _solve_qcp_batch_twophase(As, bs, cs, Q_diags=None, *,
                              sprint_mu_switch=1e-3, **kw
                              ) -> ConicDeviceResult:
    """Two-phase conic sprint: phase 1 drives every lane with the ladder
    until its barrier passes `sprint_mu_switch`; phase 2 finishes the
    unfinished lanes with the anchored-delta endgame."""
    kw.pop("mu_stop", None)
    kw.pop("init_state", None)
    kw.setdefault("cadence", "chunk")
    kw.setdefault("solver", "inverse")
    endgame = kw.pop("endgame", "delta")
    if endgame not in ("steps", "delta"):
        raise ValueError(f"endgame must be 'steps' or 'delta'; "
                         f"got {endgame!r}")
    if endgame == "steps":
        raise NotImplementedError("endgame='steps' " + _NOT_PORTED.format(11))
    compact_period = kw.pop("compact_period", 2048 if As.shape[0] > 32 else 0)
    if compact_period:
        raise NotImplementedError(
            "compact_period > 0 (straggler compaction; the default above "
            "B=32) " + _NOT_PORTED.format(11))
    phase1 = kw.pop("phase1", "ladder")
    if phase1 not in ("ladder", "sprint"):
        raise ValueError(f"phase1 must be 'ladder' or 'sprint'; "
                         f"got {phase1!r}")
    if phase1 == "sprint":
        raise NotImplementedError("phase1='sprint' (kernel K4) "
                                  + _NOT_PORTED.format(10))
    _check_options(kw.get("precision", "f64"), kw["cadence"], kw["solver"],
                   "sprint2", kw.get("k_cap"), Q_diags)
    # setup ONCE, shared by both phases
    if kw.get("prepared") is None:
        kw["prepared"] = prepare_conic_batch(
            As, bs, cs, Q_diags, cones=kw["cones"],
            rho_y=kw.get("rho_y", 1e-6), rho_x=kw.get("rho_x", 1.0),
            rho_tau=kw.get("rho_tau", 1.0),
            precision=kw.get("precision", "f64"),
            form=kw.get("form", "auto"), normalize=kw.get("normalize", False))
    kw["normalize"] = False
    r1 = _solve(As, bs, cs, Q_diags, engine="ladder",
                sprint_mu_switch=sprint_mu_switch, mu_stop=sprint_mu_switch,
                **kw)
    done1 = r1.status != 0
    if bool(done1.all()):
        return r1
    r2 = _solve(As, bs, cs, Q_diags, engine="delta",
                sprint_mu_switch=sprint_mu_switch,
                init_state=(r1.u_raw, r1.v_raw, r1.mu, r1.tol_inner,
                            r1.admm_iters, r1.ipm_iters, r1.status), **kw)
    return _select(done1, r1, r2)


def solve_qcp_batch(As, bs, cs, Q_diags=None, *, engine="steps", device=None,
                    **kw) -> ConicDeviceResult:
    """Solve a stacked batch of same-shape conic programs.

    As: (B, m, n); bs: (B, m); cs: (B, n); Q_diags: optional (B, n)
    diagonal quadratic terms; numpy arrays or tensors, on `device`
    (default: the tensors' device, CPU for numpy input).  `cones` (a
    `ConeSpec`) is shared by every lane.  engine="sprint2" runs the
    two-phase path (ladder phase 1, anchored-delta endgame); "ladder"
    and "delta" run one phase (the delta endgame needs `init_state`).
    Options of paths not ported yet (engines "steps"/"sprint",
    `phase1="sprint"`, `endgame="steps"`, `compact_period > 0`, a full
    Q, `precision="f64"`, `k_cap`) raise `NotImplementedError` naming
    their ROADMAP.md item."""
    As, bs, cs = (_as_f64(x, device) for x in (As, bs, cs))
    if Q_diags is not None:
        Q_diags = _as_f64(Q_diags, As.device)
    if engine == "sprint2":
        return _solve_qcp_batch_twophase(As, bs, cs, Q_diags, **kw)
    return _solve(As, bs, cs, Q_diags, engine=engine, **kw)


def solve_qcp_het_batch(*args, **kw):
    """Heterogeneous-cone batches (`PaddedConeLayout`) are not ported."""
    raise NotImplementedError("solve_qcp_het_batch " + _NOT_PORTED.format(11))


def host_polish(*args, **kw):
    """The host f64 polish of f32-floored lanes is not ported."""
    raise NotImplementedError("host_polish " + _NOT_PORTED.format(11))
