"""Batched conic solver, lanes on one device.

Port of `abip_tpu/parallel/batched_qcp.py`.  Every instance is a lane: a
row of `(B, ...)` tensors.  The lanes share one `ConeSpec`, or
(`solve_qcp_het_batch`) each has its own cone structure, padded to one
width (`cones.PaddedConeLayout`).  The outer barrier loop and the inner
loops run on the host; a lane whose loop condition is false is frozen by
mask, exactly as a vmapped `while_loop` freezes it, so each lane's
result equals a one-lane solve of the same instance.

Per lane:

* setup, once (`prepare_conic_batch`, f64): the cone-tied equilibration
  (or the caller's per-lane scaling), the Schur factors (precision
  "f64": the f64 Cholesky factor; "mixed": the Newton-refined explicit
  inverse; Woodbury form when 2m <= n and Q is diagonal, else primal),
  and the tau-quadratic precompute r_vec, a_coef;
* engine "steps": barrier stages of DR iterations (`conic_ops.projection`,
  `barrier_and_dual`).  Precision "f64" uses the f64 factor and f64
  products; "mixed" anchors every stage in f64 (`_AnchorQ`) and applies
  A, A' and the Schur solve as f32 deltas from the anchor, with
  `ir_steps` anchored refinement steps, at most `anchor_period`
  iterations per anchor (a stage that reaches the cap re-anchors
  without advancing the barrier).  Cadence "cond" checks the inner
  criterion every `inner_crit_period` iterations and the f64 residuals
  every `inner_check_period` (and near the end); cadence "chunk" runs
  micro-trips of `probe_period` iterations with the anchored inner
  criterion after each, then the f64 residuals and the f64 criterion
  once per chunk.  Every f32 product runs in IEEE f32 (`device.ieee_f32`);
* engine "ladder" (phase 1): launches of the ladder
  (`ops.conic_dr.fused_dr_ladder`, kernel K2 on the card) of
  T = max(2048, inner_crit_period) f32 iterations, each followed by one
  f64 residual check; engine "sprint": barrier stages of sprint chunks
  (`ops.conic_dr.fused_dr_sprint_stop`, kernel K4) with the stage rules
  below; engine "delta" (an endgame, resumed from another engine's
  state): barrier stages of anchored-delta chunks
  (`ops.conic_delta.run_conic_delta_chunk`, kernel K3), each chunk
  followed by the f64 residuals and the f64 inner criterion.  Between
  the sprint and delta stages `adjust_barrier_device`, with the
  last-resort stage budget max(16384, 8*T), its mu floor and the
  two-stall stagnation exit;
* extraction: unscale.

`solve_qcp_batch(engine="sprint2")` runs phase 1 by the ladder (or
`phase1="sprint"`) to `sprint_mu_switch`, then the unfinished lanes by
`endgame` "delta" or "steps"; with `compact_period` (the default above
B=32) in capped rounds, the unfinished lanes compacted into
power-of-two buckets between rounds.  `solve_qcp_device` solves one
instance; `host_polish` finishes a lane with the host conic driver.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import conic_ops
from ..cones import (ConeLayout, ConeSpec, PaddedConeLayout,
                     layout_operands)
from ..device import ieee_f32, resolve_device
from ..linsys.schur import DenseSchurSolver
from ..ops.admm_delta import _mv, _rmv
from ..ops.conic_delta import run_conic_delta_chunk
from ..ops.conic_dr import fused_dr_ladder, fused_dr_sprint_stop
from ..qcp import conic_defaults
from ..scaling import equilibrate_conic
from .batched import _COND_SYNC, _as_f64, _bucket, _select

f32 = torch.float32
f64 = torch.float64
i32 = torch.int32


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
    u_raw: torch.Tensor = None
    v_raw: torch.Tensor = None
    mu: torch.Tensor = None
    tol_inner: torch.Tensor = None


class PreparedConic(NamedTuple):
    """Per-lane setup: equilibrated data, Schur factors and the
    tau-quadratic precompute (`pre_calculate`, `source/abip.c:886-910`)."""

    A: torch.Tensor          # (B, m, n) scaled
    b: torch.Tensor
    c: torch.Tensor
    Q_diag: torch.Tensor     # (B, n) or full (B, n, n), scaled; or None
    D: torch.Tensor
    E: torch.Tensor
    sc_b: torch.Tensor       # (B,)
    sc_c: torch.Tensor
    nm_inf_b0: torch.Tensor  # inf-norms of the ORIGINAL data
    nm_inf_c0: torch.Tensor
    dss: DenseSchurSolver
    r_vec: torch.Tensor      # (B, m + n) K^-1(-b; c)
    a_coef: torch.Tensor     # (B,)

    def take(self, idx) -> "PreparedConic":
        """The setup of the lanes `idx` (repeats allowed), as the
        reference's compaction rounds slice it
        (`jax.tree.map(lambda a: a[idx], prep)`)."""
        return PreparedConic(*[
            None if f is None else f.take(idx)
            if isinstance(f, DenseSchurSolver) else f[idx] for f in self])


def _prepare(As, bs, cs, Q_diags, layout, *, rho_y, rho_x, rho_tau,
             precision, form, normalize) -> PreparedConic:
    B, m, n = As.shape
    dev, dtype = As.device, As.dtype
    nm_b = (torch.abs(bs).amax(-1) if m
            else torch.zeros((B,), dtype=dtype, device=dev))
    nm_c = torch.abs(cs).amax(-1)
    if normalize:
        A2, Q2, b2, c2, scal = equilibrate_conic(As, Q_diags, bs, cs, layout,
                                                 conic_defaults())
        D, E, sc_b, sc_c = scal
    else:
        A2, Q2, b2, c2 = As, Q_diags, bs, cs
        D = torch.ones((B, m), dtype=dtype, device=dev)
        E = torch.ones((B, n), dtype=dtype, device=dev)
        sc_b = torch.ones((B,), dtype=dtype, device=dev)
        sc_c = torch.ones_like(sc_b)
    full_Q = Q2 is not None and Q2.dim() == 3
    woodbury = (2 * m <= n and not full_Q) if form == "auto" \
        else form == "woodbury"
    rho_yv = torch.full((m,), rho_y, dtype=dtype, device=dev)
    rho_xv = torch.full((n,), rho_x, dtype=dtype, device=dev)
    dss = DenseSchurSolver(A2, Q2, rho_yv, rho_xv,
                           mode="newton" if precision == "mixed" else "chol",
                           form="woodbury" if woodbury else "primal")
    r_y, r_x, _ = dss.solve(-b2, c2)
    r_vec = torch.cat([r_y, r_x], dim=1)
    rho_vec = torch.cat([rho_yv, rho_xv])
    a_coef = rho_tau + (rho_vec * r_vec * r_vec).sum(-1)
    return PreparedConic(A=A2, b=b2, c=c2, Q_diag=Q2, D=D, E=E, sc_b=sc_b,
                         sc_c=sc_c, nm_inf_b0=nm_b, nm_inf_c0=nm_c, dss=dss,
                         r_vec=r_vec, a_coef=a_coef)


def prepare_conic_batch(As, bs, cs, Q_diags=None, *, cones: ConeSpec,
                        rho_y=1e-6, rho_x=1.0, rho_tau=1.0,
                        precision="f64", form="auto",
                        normalize=True) -> PreparedConic:
    """The per-lane setup, once (`batched_qcp.prepare_conic_batch`):
    equilibration, Schur factors (precision "f64": the f64 Cholesky
    factor; "mixed": the Newton-refined explicit inverse) and the
    tau-quadratic precompute.  Q_diags: None, `(B, n)` diagonal or
    `(B, n, n)` full (a full Q takes the primal form under "auto").
    Pass the result to `solve_qcp_batch(..., prepared=...)` with the
    same rho, precision and form."""
    layout = ConeLayout(cones)
    layout.spec.validate_dim(As.shape[2])
    with ieee_f32():
        return _prepare(As, bs, cs, Q_diags, layout, rho_y=rho_y,
                        rho_x=rho_x, rho_tau=rho_tau, precision=precision,
                        form=form, normalize=normalize)


def prepared_from_numpy(prep, device=None) -> PreparedConic:
    """The reference's `PreparedConic` (after `jax.device_get`: numpy
    leaves, batched, its `DenseSchurSolver` in mode "newton" or "chol")
    as the port's."""
    def t(x):
        return None if x is None else torch.from_numpy(
            np.array(x, dtype=np.float64)).to(device)

    return PreparedConic(
        A=t(prep.A), b=t(prep.b), c=t(prep.c), Q_diag=t(prep.Q_diag),
        D=t(prep.D), E=t(prep.E), sc_b=t(prep.sc_b), sc_c=t(prep.sc_c),
        nm_inf_b0=t(prep.nm_inf_b0), nm_inf_c0=t(prep.nm_inf_c0),
        dss=DenseSchurSolver.from_numpy(prep.dss, device),
        r_vec=t(prep.r_vec), a_coef=t(prep.a_coef))


class _AnchorQ(NamedTuple):
    """Per-stage anchor of the mixed-precision operators
    (`batched_qcp.py:52-66`)."""

    x0: torch.Tensor     # matvec operand anchor (x block of u)
    y0: torch.Tensor     # rmatvec operand anchor
    Ax0: torch.Tensor
    ATy0: torch.Tensor
    wy0: torch.Tensor    # projection rhs anchors
    wx0: torch.Tensor
    rhs0: torch.Tensor
    zx0: torch.Tensor    # Schur solution anchor
    Azx0: torch.Tensor
    Szx0: torch.Tensor   # S @ zx0 in f64 (anchored refinement)


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


def _device_solve_qcp(P: PreparedConic, layout, *, engine, precision,
                      cadence, eps, max_ipm, max_admm, kcap, alpha, rho_y,
                      rho_x, rho_tau, psi, inner_check_period, ir_steps,
                      inner_crit_period, anchor_period, probe_period,
                      mu_stop, init_state) -> ConicDeviceResult:
    """`_device_solve_qcp` (`batched_qcp.py:92-786`) after its checks and
    setup, every lane at once.  `kcap` is the per-lane `(B,)` ADMM cap."""
    A, b, c, Qd = P.A, P.b, P.c, P.Q_diag
    B, m, n = A.shape
    dev = A.device
    dss = P.dss
    woodbury = dss.form == "woodbury"
    mixed = precision == "mixed"
    full_Q = Qd is not None and Qd.dim() == 3
    co = layout_operands(layout, dev)
    rho = torch.cat([torch.full((m,), rho_y, dtype=f64, device=dev),
                     torch.full((n,), rho_x, dtype=f64, device=dev),
                     torch.full((1,), rho_tau, dtype=f64, device=dev)])
    rho_tail = rho[m:]
    ry_inv = 1.0 / rho[:m]
    probe = min(probe_period, inner_crit_period)
    zi = torch.zeros((B,), dtype=i32, device=dev)

    def Q_times(x):
        if Qd is None:
            return torch.zeros_like(x)
        return _mv(Qd, x) if full_Q else Qd * x

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

    def inf_lanes():
        return torch.full((B,), float("inf"), dtype=f64, device=dev)

    # ------------------------------------------------------------------ #
    # the fused-kernel engines (ladder, sprint, delta)                   #
    # ------------------------------------------------------------------ #
    if engine != "steps":
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

    def sprint_chunk(s: _Inner, o: _Outer, act) -> _Inner:
        """One K4 launch: up to inner_crit_period f32 iterations at the
        stage's barrier with the in-kernel stop, then the f64
        residual/status check; the stage criterion is the kernel's f32
        value (`batched_qcp.py:556-574`)."""
        u, v, t_done, err = fused_dr_sprint_stop(
            A32, Minv32, Hinv32, P.r_vec.to(f32), b.to(f32), c.to(f32),
            Qd32, co, rho_y, rho_x, rho_tau, P.a_coef, o.mu, alpha,
            o.tol_inner, s.u.to(f32), s.v.to(f32), s.k.to(f32),
            T=inner_crit_period, probe=probe, woodbury=woodbury, active=act)
        u, v = u.to(f64), v.to(f64)
        v_origin = rho * v
        k = s.k + t_done
        r = residuals(u, v_origin, s.res)
        return _Inner(u=u, v=v, v_origin=v_origin, j=s.j + t_done, k=k,
                      err_inner=err.to(f64),
                      status=converged(r, (o.i > 0) & (k > 0)), res=r)

    def kernel_stage(o: _Outer, alive) -> _Outer:
        """One barrier stage of sprint or delta chunks, then
        `adjust_barrier` with the stage budget, mu floor and stagnation
        exit (`batched_qcp.py:635-685`)."""
        chunk = sprint_chunk if engine == "sprint" else delta_chunk
        s = o.inner._replace(j=zi, err_inner=inf_lanes(), status=zi)
        while True:
            act = (alive & (s.err_inner >= o.tol_inner) & (s.status == 0)
                   & (s.k < kcap) & (s.j < stage_budget))
            if not bool(act.any()):
                break
            s = _select(act, chunk(s, o, act), s)
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

    # ------------------------------------------------------------------ #
    # the steps engine                                                   #
    # ------------------------------------------------------------------ #
    if engine == "steps" and mixed:
        A32 = A.to(f32).contiguous()
        ry_inv32 = ry_inv.to(f32)
        Minv32 = dss.Minv64.to(f32)
        if woodbury:
            H_inv32 = dss.H_inv.to(f32)
            H = 1.0 / dss.H_inv

            def solve32(r32):
                """f32 S^-1 apply through the dual factor."""
                t = H_inv32 * r32
                return t - H_inv32 * _rmv(A32, _mv(Minv32, _mv(A32, t)))

            def S_times32(dz32):
                """S dz with f32 products, matrix-free: S = H + A'Ry^-1 A."""
                return H * dz32.to(f64) + _rmv(
                    A32, ry_inv32 * _mv(A32, dz32)).to(f64)
        else:
            S = ((A * ry_inv[:, None]).transpose(-1, -2) @ A
                 + rho_x * torch.eye(n, dtype=f64, device=dev))
            if full_Q:
                S = S + Qd
            elif Qd is not None:
                S = S + torch.diag_embed(Qd)
            S32 = S.to(f32)

            def solve32(r32):
                return _mv(Minv32, r32)

            def S_times32(dz32):
                return _mv(S32, dz32).to(f64)

    def S_times64(z):
        """f64 S @ z matrix-free (anchor setup, once per stage)."""
        return rho_x * z + Q_times(z) + rmv64(ry_inv * mv64(z))

    def make_anchor(u, v) -> _AnchorQ:
        """One f64-quality pass per barrier stage."""
        x0, y0 = u[:, m:m + n], u[:, :m]
        w = rho[:m + n] * (u[:, :m + n] + v[:, :m + n])
        wy0, wx0 = w[:, :m], w[:, m:]
        _, zx0, _ = dss.solve(wy0, wx0)
        return _AnchorQ(x0=x0, y0=y0, Ax0=mv64(x0), ATy0=rmv64(y0), wy0=wy0,
                        wx0=wx0, rhs0=wx0 + rmv64(ry_inv * wy0), zx0=zx0,
                        Azx0=mv64(zx0), Szx0=S_times64(zx0))

    def make_ops(anc: _AnchorQ):
        """(matvec, rmatvec, solve) of one stage: f64, or f32 deltas from
        the stage anchor."""
        if not mixed:
            return mv64, rmv64, dss.solve

        def amv(x):
            return anc.Ax0 + _mv(A32, (x - anc.x0).to(f32)).to(f64)

        def armv(y):
            return anc.ATy0 + _rmv(A32, (y - anc.y0).to(f32)).to(f64)

        def anchored_solve(w_y, w_x, k, warm):
            dwy32 = (w_y - anc.wy0).to(f32)
            drhs = (w_x - anc.wx0) + _rmv(A32, ry_inv32 * dwy32).to(f64)
            z_x = anc.zx0 + solve32(drhs.to(f32)).to(f64)
            rhs = anc.rhs0 + drhs
            for _ in range(ir_steps):
                # anchored refinement: S z = Szx0 + S32 (z - zx0)
                Sz = anc.Szx0 + S_times32((z_x - anc.zx0).to(f32))
                z_x = z_x + solve32((rhs - Sz).to(f32)).to(f64)
            Az = anc.Azx0 + _mv(A32, (z_x - anc.zx0).to(f32)).to(f64)
            return ry_inv * (w_y - Az), z_x, 0

        return amv, armv, anchored_solve

    def dr_step(u, v, mu, k, stage_solve):
        u_t, _ = conic_ops.projection(u, v, stage_solve, rho, P.r_vec,
                                      P.a_coef, Q_times, m, n, k)
        return conic_ops.barrier_and_dual(u, v, u_t, mu, rho_tail, layout,
                                          alpha, m, n, co)

    def inner_cond(s: _Inner, o: _Outer, alive, ops, stage_cap) -> _Inner:
        """Cadence "cond" (`batched_qcp.py:453-497`): one iteration per
        trip.  Every lane starts the stage at j = 0 and stops advancing
        only when frozen, so a live lane's j + 1 is the trip number and
        the period tests are host decisions.  The host reads "any lane
        alive" (and "any lane near the end") every few trips, and after
        every trip that checked residuals."""
        mv, rmv, stage_solve = ops
        endgame_p = inner_crit_period if mixed else 1
        jp, read, near = 0, True, False
        while True:
            act = (alive & (s.j < stage_cap) & (s.err_inner >= o.tol_inner)
                   & (s.status == 0) & (s.k < kcap))
            if read:
                near_end = act & (s.res.error_ratio <= 8.0)
                any_act, near = torch.stack(
                    [act.any(), near_end.any()]).tolist()
                if not any_act:
                    break
            jp += 1
            u, v = dr_step(s.u, s.v, o.mu, s.k, stage_solve)
            v_origin = rho * v
            k = s.k + 1
            # the inner HSD-mismatch criterion, every inner_crit_period-th
            # iteration (every iteration at 1, as the reference's host loop)
            if jp % inner_crit_period == 0:
                err = conic_ops.inner_conv_check(u, v_origin, mv, rmv,
                                                 Q_times, b, c, m, n)
            else:
                err = s.err_inner
            # residual checks use true f64 products, never the anchored
            # f32 deltas (an f32 product floors the measured residual)
            every = jp % inner_check_period == 0
            endgame = near and jp % endgame_p == 0
            if every or endgame:
                r_new = residuals(u, v_origin, s.res)
                st_new = converged(r_new, (o.i > 0) & (k > 0))
                chk = (torch.ones_like(act) if every
                       else s.res.error_ratio <= 8.0)
                r = _select(chk, r_new, s.res)
                st = torch.where(chk, st_new, 0).to(i32)
            else:
                r, st = s.res, zi
            s = _select(act, _Inner(u=u, v=v, v_origin=v_origin, j=s.j + 1,
                                    k=k, err_inner=err, status=st, res=r), s)
            read = jp % _COND_SYNC == 0 or every or endgame
        return s

    def chunk_steps(s: _Inner, o: _Outer, act, ops, stage_cap) -> _Inner:
        """Cadence "chunk" (`batched_qcp.py:499-554`): micro-trips of
        `probe` iterations, each followed by the inner criterion through
        the stage's operators (one host read per trip), then the f64
        residual check and the f64-authoritative criterion once per
        chunk.  The projection sees the chunk's entry k, as the
        reference's does."""
        mv, rmv, stage_solve = ops
        t = (s.u, s.v, zi, s.err_inner)
        while True:
            u, v, dk, err = t
            mc = (act & (err >= o.tol_inner) & (dk < inner_crit_period)
                  & (s.j + dk < stage_cap) & (s.k + dk < kcap))
            if not bool(mc.any()):
                break
            for _ in range(probe):
                u, v = dr_step(u, v, o.mu, s.k, stage_solve)
            err = conic_ops.inner_conv_check(u, rho * v, mv, rmv, Q_times, b,
                                             c, m, n)
            t = _select(mc, (u, v, dk + probe, err), t)
        u, v, dk, _ = t
        v_origin = rho * v
        k = s.k + dk
        r = residuals(u, v_origin, s.res)
        err64 = conic_ops.inner_conv_check(u, v_origin, mv64, rmv64, Q_times,
                                           b, c, m, n)
        return _Inner(u=u, v=v, v_origin=v_origin, j=s.j + dk, k=k,
                      err_inner=err64,
                      status=converged(r, (o.i > 0) & (k > 0)), res=r)

    def steps_stage(o: _Outer, alive) -> _Outer:
        """One barrier stage of the steps engine
        (`batched_qcp.py:686-728`): a fresh anchor in mixed precision,
        the inner loop to the stage criterion or the per-anchor cap, then
        `adjust_barrier`; a cap exit re-anchors without advancing the
        barrier."""
        s = o.inner._replace(j=zi, err_inner=inf_lanes(), status=zi)
        ops = make_ops(make_anchor(s.u, s.v) if mixed else None)
        # mixed: the anchored f32 deltas lose accuracy as the iterate
        # drifts from the anchor, so a stage re-anchors every
        # anchor_period iterations; f64 has no anchor
        stage_cap = anchor_period if mixed else max_admm
        if cadence == "chunk":
            while True:
                act = (alive & (s.j < stage_cap)
                       & (s.err_inner >= o.tol_inner) & (s.status == 0)
                       & (s.k < kcap))
                if not bool(act.any()):
                    break
                s = _select(act, chunk_steps(s, o, act, ops, stage_cap), s)
        else:
            s = inner_cond(s, o, alive, ops, stage_cap)
        r = residuals(s.u, s.v_origin, s.res)
        st = torch.where(s.status != 0, s.status,
                         converged(r, (o.i > 0) & (s.k > 0)))
        mu, tol = conic_ops.adjust_barrier_device(o.mu, r.error_ratio, eps,
                                                  psi)
        done = st != 0
        cap_exit = s.err_inner >= o.tol_inner
        mu = torch.where(done | cap_exit, o.mu, mu)
        tol = torch.where(cap_exit, o.tol_inner, tol)
        return _Outer(inner=s._replace(res=r, status=st.to(i32)), mu=mu,
                      tol_inner=tol,
                      i=o.i + torch.where(cap_exit, 0, 1).to(i32),
                      stall=torch.zeros_like(o.stall))

    res0 = conic_ops.ConicResiduals.init(B, f64, dev)
    if init_state is None:
        x0 = layout.interior_point(f64, dev).expand(B, n)
        u0 = torch.cat([torch.zeros((B, m), dtype=f64, device=dev), x0,
                        torch.ones((B, 1), dtype=f64, device=dev)], dim=1)
        o = _Outer(
            inner=_Inner(u=u0, v=u0.clone(), v_origin=rho * u0, j=zi, k=zi,
                         err_inner=inf_lanes(), status=zi, res=res0),
            mu=torch.ones((B,), dtype=f64, device=dev),
            tol_inner=torch.full((B,), 4.0, dtype=f64, device=dev), i=zi,
            stall=zi)
    else:
        # phase hand-off resume: (u, v, mu, tol_inner, k, i, status)
        def t(x, dtype):
            return torch.as_tensor(x, device=dev).to(dtype)

        u_i, v_i, mu_i, tol_i, k_i, i_i, st_i = init_state
        v_i = t(v_i, f64).reshape(B, -1)
        o = _Outer(
            inner=_Inner(u=t(u_i, f64).reshape(B, -1), v=v_i,
                         v_origin=rho * v_i,
                         j=zi, k=t(k_i, i32).reshape(B),
                         err_inner=inf_lanes(),
                         status=t(st_i, i32).reshape(B), res=res0),
            mu=t(mu_i, f64).reshape(B), tol_inner=t(tol_i, f64).reshape(B),
            i=t(i_i, i32).reshape(B), stall=zi)

    body = {"ladder": ladder_body, "steps": steps_stage}.get(engine,
                                                              kernel_stage)
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


def _solve(As, bs, cs, Q_diags, *, cones, engine="steps", eps=1e-4,
           max_ipm=200, max_admm=100_000, alpha=1.8, rho_y=1e-6, rho_x=1.0,
           rho_tau=1.0, psi=1.0, inner_check_period=500, precision="f64",
           ir_steps=1, inner_crit_period=1, solver="cholesky",
           normalize=False, anchor_period=100, form="auto", cadence="chunk",
           probe_period=8, sprint_mu_switch=1e-3, mu_stop=0.0,
           init_state=None, k_cap=None, prepared=None,
           scaling=None) -> ConicDeviceResult:
    """One program of the reference's `_solve_qcp_batch_jit` (its options,
    defaults and checks, `batched_qcp.py:112-255`), every engine.

    `cones` is a `ConeSpec` shared by every lane or a
    `PaddedConeLayout` (the steps engine only).  `scaling` is a per-lane
    (D, E, sc_b, sc_c, nm_inf_b0, nm_inf_c0) tuple for data the caller
    already equilibrated.  `solver` acts on no conic engine (the
    reference's neither); `prepared` (from `prepare_conic_batch`) skips
    the setup."""
    # period knobs must be >= 1: anchor_period < 1 in mixed mode would
    # re-anchor forever without advancing k
    if anchor_period < 1 or inner_crit_period < 1 or inner_check_period < 1 \
            or probe_period < 1:
        raise ValueError(
            "anchor_period, inner_crit_period, inner_check_period, and "
            f"probe_period must be >= 1; got {anchor_period}, "
            f"{inner_crit_period}, {inner_check_period}, {probe_period}")
    if cadence not in ("cond", "chunk"):
        raise ValueError(f"cadence must be 'cond' or 'chunk'; got {cadence!r}")
    if engine not in ("steps", "sprint", "ladder", "delta"):
        raise ValueError(f"engine must be 'steps', 'sprint', 'ladder', or "
                         f"'delta'; got {engine!r}")
    if precision not in ("f64", "mixed"):
        raise ValueError(f"precision must be 'f64' or 'mixed'; got "
                         f"{precision!r}")
    if solver not in ("cholesky", "inverse"):
        raise ValueError(f"unknown solver {solver!r}")
    if engine == "delta" and cadence != "chunk":
        raise ValueError("engine='delta' requires cadence='chunk'")
    if engine == "delta" and init_state is None:
        # the conic delta chunk does NOT implement the first-iteration
        # tau_t := 1 case (`source/abip.c:186-254`): it is an ENDGAME
        raise ValueError(
            "engine='delta' is an endgame: pass init_state from a prior "
            "steps/sprint phase (cold start lacks the k=0 tau_t=1 case)")
    padded = isinstance(cones, PaddedConeLayout)
    if engine in ("sprint", "ladder"):
        # the fused kernels are pure f32: they run phase-1 style, above
        # the mu switch, and take a static cone layout
        if not (mu_stop and mu_stop >= sprint_mu_switch):
            raise ValueError(f"engine={engine!r} runs phase-1 style: pass "
                             "mu_stop >= sprint_mu_switch")
        if cadence != "chunk":
            raise ValueError(f"engine={engine!r} requires cadence='chunk'")
    if engine != "steps" and padded:
        raise ValueError(f"engine={engine!r} requires a static ConeLayout "
                         "(heterogeneous padded layouts use steps)")
    layout = cones if padded else ConeLayout(cones)
    if prepared is not None:
        if normalize or scaling is not None:
            raise ValueError("prepared already carries the scaling; do not "
                             "also pass normalize=True or scaling=")
        want = "newton" if precision == "mixed" else "chol"
        if prepared.dss.mode != want:
            raise ValueError(
                f"prepared factors were built mode={prepared.dss.mode!r} "
                f"but precision={precision!r} needs {want!r}: call "
                "prepare_conic_batch with the same precision")
        A = prepared.A
        full_Q = prepared.Q_diag is not None and prepared.Q_diag.dim() == 3
        woodbury = prepared.dss.form == "woodbury"
    else:
        if scaling is not None and normalize:
            raise ValueError("pass either normalize=True or scaling, not "
                             "both")
        A = As
        full_Q = Q_diags is not None and Q_diags.dim() == 3
        woodbury = (2 * A.shape[1] <= A.shape[2] and not full_Q
                    if form == "auto" else form == "woodbury")
    B, m, n = A.shape
    if woodbury and m >= n:
        raise ValueError("form='woodbury' requires m < n")
    if woodbury and full_Q:
        raise ValueError("form='woodbury' requires a diagonal (or no) Q")
    if engine != "steps" and full_Q:
        raise ValueError(f"engine={engine!r} supports diagonal (or no) Q")
    if not padded:
        layout.spec.validate_dim(n)
    kcap = torch.full((B,), max_admm, dtype=i32, device=A.device)
    if k_cap is not None:
        kcap = torch.minimum(kcap, torch.as_tensor(
            k_cap, device=A.device).to(i32).expand(B))
    with ieee_f32():
        if prepared is None:
            prepared = _prepare(As, bs, cs, Q_diags, layout, rho_y=rho_y,
                                rho_x=rho_x, rho_tau=rho_tau,
                                precision=precision,
                                form="woodbury" if woodbury else "primal",
                                normalize=normalize)
            if scaling is not None:
                D, E, sc_b, sc_c, nm_b, nm_c = scaling
                prepared = prepared._replace(D=D, E=E, sc_b=sc_b, sc_c=sc_c,
                                             nm_inf_b0=nm_b, nm_inf_c0=nm_c)
        return _device_solve_qcp(
            prepared, layout, engine=engine, precision=precision,
            cadence=cadence, eps=eps, max_ipm=max_ipm, max_admm=max_admm,
            kcap=kcap, alpha=alpha, rho_y=rho_y, rho_x=rho_x,
            rho_tau=rho_tau, psi=psi, inner_check_period=inner_check_period,
            ir_steps=ir_steps, inner_crit_period=inner_crit_period,
            anchor_period=anchor_period, probe_period=probe_period,
            mu_stop=mu_stop, init_state=init_state)


def _resume(r: ConicDeviceResult):
    return (r.u_raw, r.v_raw, r.mu, r.tol_inner, r.admm_iters, r.ipm_iters,
            r.status)


def _solve_qcp_batch_twophase(As, bs, cs, Q_diags=None, *,
                              sprint_mu_switch=1e-3, **kw
                              ) -> ConicDeviceResult:
    """Two-phase conic sprint (`batched_qcp.py:806-937`).  Phase 1 drives
    every lane with the ladder (`phase1="ladder"`, K2) or the per-stage
    sprint (`phase1="sprint"`, K4) until its barrier passes
    `sprint_mu_switch`; phase 2 finishes the unfinished lanes with the
    anchored-delta endgame (`endgame="delta"`, K3) or the steps engine
    (`endgame="steps"`).  With `compact_period` > 0 (default 2048 above
    B=32, else 0) phase 2 runs in rounds: every active lane runs to one
    shared total-iteration cap, the prior maximum plus `compact_period`;
    a lane that finished, reached a cap or made no progress leaves, and
    the rest are compacted into the next power-of-two bucket (at least
    4, filled with copies of active lanes) and the prepared setup sliced
    to it, never recomputed."""
    kw.pop("mu_stop", None)
    kw.pop("init_state", None)
    kw.setdefault("cadence", "chunk")
    kw.setdefault("solver", "inverse")
    endgame = kw.pop("endgame", "delta")
    if endgame not in ("steps", "delta"):
        raise ValueError(f"endgame must be 'steps' or 'delta'; "
                         f"got {endgame!r}")
    compact_period = kw.pop("compact_period", 2048 if As.shape[0] > 32 else 0)
    phase1 = kw.pop("phase1", "ladder")
    if phase1 not in ("ladder", "sprint"):
        raise ValueError(f"phase1 must be 'ladder' or 'sprint'; "
                         f"got {phase1!r}")
    # setup ONCE, shared by both phases and every compaction round
    prep = kw.pop("prepared", None)
    if prep is None:
        prep = prepare_conic_batch(
            As, bs, cs, Q_diags, cones=kw["cones"],
            rho_y=kw.get("rho_y", 1e-6), rho_x=kw.get("rho_x", 1.0),
            rho_tau=kw.get("rho_tau", 1.0),
            precision=kw.get("precision", "f64"), form=kw.get("form", "auto"),
            normalize=kw.get("normalize", False))
    kw["normalize"] = False
    r1 = _solve(As, bs, cs, Q_diags, engine=phase1, prepared=prep,
                sprint_mu_switch=sprint_mu_switch, mu_stop=sprint_mu_switch,
                **kw)
    done1 = r1.status != 0
    if bool(done1.all()):
        return r1
    engine2 = "delta" if endgame == "delta" else "steps"
    if not compact_period:
        r2 = _solve(As, bs, cs, Q_diags, engine=engine2, prepared=prep,
                    sprint_mu_switch=sprint_mu_switch, init_state=_resume(r1),
                    **kw)
        return _select(done1, r1, r2)

    dev = As.device
    max_admm = kw.get("max_admm", 100_000)
    max_ipm = kw.get("max_ipm", 200)
    out = [f.clone() for f in r1]
    state = [t.clone() for t in _resume(r1)]
    _K, _I = 4, 5                                 # admm / ipm slots
    active = np.flatnonzero(~done1.cpu().numpy())
    while active.size:
        nb = _bucket(active.size)
        # the bucket is filled with copies of active lanes
        idx = torch.as_tensor(active[np.arange(nb) % active.size],
                              device=dev)
        act = torch.as_tensor(active, device=dev)
        prev_k = state[_K][act].cpu().numpy()
        prev_i = state[_I][act].cpu().numpy()
        # one SHARED scalar cap: every active lane runs to the same rung
        caps = min(int(prev_k.max()) + compact_period, max_admm)
        r2 = _solve(None, None, None, None, engine=engine2,
                    prepared=prep.take(idx),
                    sprint_mu_switch=sprint_mu_switch,
                    init_state=tuple(s[idx] for s in state), k_cap=caps, **kw)
        live = slice(0, active.size)              # non-duplicate rows
        k2 = r2.admm_iters[live].cpu().numpy()
        i2 = r2.ipm_iters[live].cpu().numpy()
        # finished: converged, at the ADMM or IPM cap, or no progress
        fin = ((r2.status[live].cpu().numpy() != 0) | (k2 >= max_admm)
               | (i2 >= max_ipm) | ((k2 <= prev_k) & (i2 <= prev_i)))
        fin_t = torch.as_tensor(fin, device=dev)
        for f_out, f_new in zip(out, r2):
            f_out[act[fin_t]] = f_new[live][fin_t]
        for s_arr, f_new in zip(state, _resume(r2)):
            s_arr[act[~fin_t]] = f_new[live][~fin_t]
        active = active[~fin]
    return ConicDeviceResult(*out)


def solve_qcp_batch(As, bs, cs, Q_diags=None, *, engine="steps", device=None,
                    **kw) -> ConicDeviceResult:
    """Solve a stacked batch of same-shape conic programs.

    As: (B, m, n); bs: (B, m); cs: (B, n); Q_diags: optional (B, n)
    diagonal or (B, n, n) full quadratic terms (a full Q takes the
    primal Schur form); numpy arrays or tensors, moved to `device`
    (default: the CUDA card; `device="cpu"` runs on the CPU).  `cones` (a
    `ConeSpec`) is shared by every lane.  Options and defaults are the
    reference's (`_solve_qcp_batch_jit`): engine "steps" (default,
    precision "f64" or "mixed", cadence "chunk" or "cond"), "ladder" and
    "sprint" (phase 1, with `mu_stop`), "delta" (an endgame, with
    `init_state`), or "sprint2" (the two-phase path:
    `_solve_qcp_batch_twophase`).  `max_admm` is the TOTAL ADMM budget
    over all barrier stages; `k_cap` (an int or `(B,)` ints) caps it
    lower; `init_state` resumes each lane from (u, v, mu, tol_inner, k,
    i, status).  precision="mixed" wants rho_y >= 1e-3 (the f32 Schur
    apply degrades with cond(S) ~ 1/rho_y)."""
    dev = resolve_device(device)
    As, bs, cs = (_as_f64(x, dev) for x in (As, bs, cs))
    if Q_diags is not None:
        Q_diags = _as_f64(Q_diags, As.device)
    if engine == "sprint2":
        return _solve_qcp_batch_twophase(As, bs, cs, Q_diags, **kw)
    return _solve(As, bs, cs, Q_diags, engine=engine, **kw)


def solve_qcp_device(A, b, c, Q_diag=None, *, cones: ConeSpec, eps=1e-4,
                     max_ipm=200, max_admm=100_000, alpha=1.8, rho_y=1e-6,
                     rho_x=1.0, rho_tau=1.0, psi=1.0, inner_check_period=500,
                     precision="f64", ir_steps=1, inner_crit_period=1,
                     solver="cholesky", normalize=False, anchor_period=100,
                     form="auto", cadence="cond", probe_period=8,
                     device=None) -> ConicDeviceResult:
    """One instance, the whole solve by the steps engine
    (`batched_qcp.py:1090-1117`): B=1 with the reference's defaults
    (cadence "cond", precision "f64", inner_crit_period=1).  Q_diag:
    None, `(n,)` diagonal or `(n, n)` full.  Returns one lane's
    `ConicDeviceResult`: scalar counters and residuals, `(n,)` x and s,
    `(m,)` y."""
    dev = resolve_device(device)
    A, b, c = (_as_f64(x, dev)[None] for x in (A, b, c))
    Q = None if Q_diag is None else _as_f64(Q_diag, dev)[None]
    r = _solve(A, b, c, Q, cones=cones, engine="steps", eps=eps,
               max_ipm=max_ipm, max_admm=max_admm, alpha=alpha, rho_y=rho_y,
               rho_x=rho_x, rho_tau=rho_tau, psi=psi,
               inner_check_period=inner_check_period, precision=precision,
               ir_steps=ir_steps, inner_crit_period=inner_crit_period,
               solver=solver, normalize=normalize,
               anchor_period=anchor_period, form=form, cadence=cadence,
               probe_period=probe_period)
    return ConicDeviceResult(*[f[0] for f in r])


# ---------------------------------------------------------------------- #
# heterogeneous-cone batching                                             #
# ---------------------------------------------------------------------- #
def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def pad_conic_instances(problems, dtype=torch.float64, device=None):
    """Pad conic instances of DIFFERENT shapes and cone structures to one
    stacked batch (`batched_qcp.py:1123-1178`).

    problems: sequence of (A, b, c, Q_or_None, ConeSpec).  Returns
    (As, bs, cs, Qs, layout, dims): As (B, m_pad, n_pad), bs (B, m_pad),
    cs (B, n_pad) on `device` (default: the CUDA card); Qs None,
    (B, n_pad) diagonal or (B, n_pad, n_pad) full (any full Q promotes
    the whole batch); layout the stacked `PaddedConeLayout`; dims the
    natural (m_i, n_i).  Padding is the inert embedding: extra columns
    are zero-cone elements with zero A columns and c entries, extra rows
    zero rows with b = 0."""
    dev = resolve_device(device)
    B = len(problems)
    dims = [tuple(np.shape(p[0])[:2]) for p in problems]
    m_pad = max(m for m, _ in dims)
    n_pad = max(n for _, n in dims)
    layout = PaddedConeLayout.stack([p[4] for p in problems], n_pad=n_pad)
    any_q = any(p[3] is not None for p in problems)
    full_q = any(p[3] is not None and np.ndim(p[3]) == 2 for p in problems)
    As = np.zeros((B, m_pad, n_pad))
    bs = np.zeros((B, m_pad))
    cs = np.zeros((B, n_pad))
    Qs = (None if not any_q else np.zeros((B, n_pad, n_pad)) if full_q
          else np.zeros((B, n_pad)))
    for k, (A, b, c, Q, _spec) in enumerate(problems):
        m, n = dims[k]
        As[k, :m, :n] = _np(A)
        bs[k, :m] = _np(b).ravel()
        cs[k, :n] = _np(c).ravel()
        if Q is None:
            continue
        Q = _np(Q)
        if full_q:
            Qs[k, :n, :n] = Q if Q.ndim == 2 else np.diag(Q)
        else:
            Qs[k, :n] = Q

    def t(x):
        return None if x is None else torch.as_tensor(x, dtype=dtype,
                                                      device=dev)

    return t(As), t(bs), t(cs), t(Qs), layout, dims


def solve_qcp_het_batch(problems, *, eps=1e-4, max_ipm=200,
                        max_admm=100_000, alpha=1.8, rho_y=1e-6, rho_x=1.0,
                        rho_tau=1.0, psi=1.0, inner_check_period=500,
                        precision="f64", ir_steps=1, inner_crit_period=1,
                        solver="cholesky", normalize=True, anchor_period=100,
                        form="auto", cadence="chunk", probe_period=8,
                        route="auto", device=None) -> ConicDeviceResult:
    """Solve conic programs of HETEROGENEOUS shapes and cone structures as
    one batch (`batched_qcp.py:1211-1318`), on `device` (default: the
    CUDA card).

    problems: sequence of (A, b, c, Q_or_None, ConeSpec).  route
    "batch" pads them to one steps-engine batch whose cone layout is lane
    data (`PaddedConeLayout`); "pool" solves each with
    `solve_qcp_device` and pads the results; "auto" (default) takes the
    pool where the padded batch would do more than twice the natural
    shapes' work (B * m_pad * n_pad against the sum of m_i * n_i).
    normalize=True equilibrates each lane at its natural shape before
    padding and ships the per-lane scalings as data, so residuals and
    solutions refer to the original data.  Returns a `ConicDeviceResult`
    with padded (B, n_pad) / (B, m_pad) solutions; slice lane k by its
    natural dims (the padding is exactly zero)."""
    if route not in ("auto", "batch", "pool"):
        raise ValueError(f"route must be 'auto', 'batch', or 'pool'; "
                         f"got {route!r}")
    dev = resolve_device(device)
    if route == "auto":
        m_pad = max(np.shape(p[0])[0] for p in problems)
        n_pad = max(np.shape(p[0])[1] for p in problems)
        nat = sum(np.shape(p[0])[0] * np.shape(p[0])[1] for p in problems)
        waste = len(problems) * m_pad * n_pad / max(nat, 1)
        route = "pool" if waste > 2.0 else "batch"
    kw = dict(eps=eps, max_ipm=max_ipm, max_admm=max_admm, alpha=alpha,
              rho_y=rho_y, rho_x=rho_x, rho_tau=rho_tau, psi=psi,
              inner_check_period=inner_check_period, precision=precision,
              ir_steps=ir_steps, inner_crit_period=inner_crit_period,
              solver=solver, anchor_period=anchor_period, form=form,
              cadence=cadence, probe_period=probe_period)
    if route == "pool":
        return _solve_qcp_het_pool(problems, normalize=normalize, device=dev,
                                   **kw)
    scal_rows = None
    if normalize:
        scaled, scal_rows = [], []
        for (A, b, c, Q, spec) in problems:
            A, b, c = (_as_f64(_np(x), dev) for x in (A, b, c))
            Qj = None if Q is None else _as_f64(_np(Q), dev)
            nm_b = (float(torch.abs(b).max()) if b.shape[0] else 0.0)
            nm_c = float(torch.abs(c).max())
            with ieee_f32():
                A2, Q2, b2, c2, sc = equilibrate_conic(
                    A[None], None if Qj is None else Qj[None], b[None],
                    c[None], ConeLayout(spec), conic_defaults())
            scaled.append((_np(A2[0]), _np(b2[0]), _np(c2[0]),
                           None if Q2 is None else _np(Q2[0]), spec))
            scal_rows.append((_np(sc.D[0]), _np(sc.E[0]), float(sc.sc_b[0]),
                              float(sc.sc_c[0]), nm_b, nm_c))
        problems = scaled
    As, bs, cs, Qs, layout, _dims = pad_conic_instances(problems, device=dev)
    B, m_pad = bs.shape
    n_pad = cs.shape[1]
    D = np.ones((B, m_pad))
    E = np.ones((B, n_pad))
    sc_b = np.ones(B)
    sc_c = np.ones(B)
    nm_b0 = np.abs(_np(bs)).max(axis=1, initial=0.0)
    nm_c0 = np.abs(_np(cs)).max(axis=1)
    if scal_rows is not None:
        for k, (Dk, Ek, sbk, sck, nbk, nck) in enumerate(scal_rows):
            D[k, :Dk.shape[0]] = Dk
            E[k, :Ek.shape[0]] = Ek
            sc_b[k], sc_c[k], nm_b0[k], nm_c0[k] = sbk, sck, nbk, nck
    scaling = tuple(_as_f64(x, dev) for x in (D, E, sc_b, sc_c, nm_b0,
                                                nm_c0))
    return _solve(As, bs, cs, Qs, cones=layout, engine="steps",
                  normalize=False, scaling=scaling, **kw)


def _solve_qcp_het_pool(problems, *, normalize, device,
                        **kw) -> ConicDeviceResult:
    """The per-instance route for heterogeneous suites
    (`batched_qcp.py:1321-1353`): `solve_qcp_device` per instance, the
    results padded back to the het-batch contract."""
    m_pad = max(np.shape(p[0])[0] for p in problems)
    n_pad = max(np.shape(p[0])[1] for p in problems)
    outs = [solve_qcp_device(_np(A), _np(b), _np(c),
                             None if Q is None else _np(Q), cones=spec,
                             normalize=normalize, device=device, **kw)
            for (A, b, c, Q, spec) in problems]

    def padded(field, width):
        return torch.stack([torch.nn.functional.pad(
            getattr(r, field), (0, width - getattr(r, field).shape[0]))
            for r in outs])

    def scalar(field):
        return torch.stack([getattr(r, field) for r in outs])

    return ConicDeviceResult(
        x=padded("x", n_pad), y=padded("y", m_pad), s=padded("s", n_pad),
        status=scalar("status"), ipm_iters=scalar("ipm_iters"),
        admm_iters=scalar("admm_iters"), res_pri=scalar("res_pri"),
        res_dual=scalar("res_dual"), rel_gap=scalar("rel_gap"),
        pobj=scalar("pobj"), dobj=scalar("dobj"))


def host_polish(A, b, c, cones: ConeSpec, result: ConicDeviceResult,
                lane=0, *, eps, Q=None, mu_floor=1e-12, device=None,
                **overrides):
    """Finish a batched lane with the host conic driver in f64
    (`batched_qcp.py:1356-1407`), on `device` (default: the CUDA card;
    Hopper computes f64 natively, so the polish stays on the card).

    Builds a `ConicWorkspace` (its own equilibration) with
    `conic_defaults(eps=eps, **overrides)`, maps the lane's unscaled
    (x, y, s) into it (`ConicWorkspace._warm_start`), and resumes at the
    lane's barrier through a `ConicCheckpoint`: mu clamped to
    [max(mu_floor, eps), 1] (a stage-stall guard may have driven the
    lane's mu below what its iterate earned), tol_inner = 4 mu^psi, the
    lane's ADMM count.  Returns the driver's `ConicSolution`."""
    from ..qcp import ConicWorkspace
    from ..utils.checkpoint import ConicCheckpoint

    x, y, s = (_np(f[lane]).astype(np.float64)
               for f in (result.x, result.y, result.s))
    k0 = int(_np(result.admm_iters[lane]))
    stgs = conic_defaults(eps=eps, **overrides)
    mu = min(max(float(_np(result.mu[lane])), mu_floor, eps), 1.0)
    tol_inner = 4.0 * mu ** stgs.psi
    w = ConicWorkspace(_np(A).astype(np.float64), _np(b).astype(np.float64),
                       _np(c).astype(np.float64), cones,
                       Q=None if Q is None else _np(Q).astype(np.float64),
                       settings=stgs, device=device)
    u, v = w._warm_start((x, y, s), mu, 1.0)
    ck = ConicCheckpoint(u=_np(u[0]), v=_np(v[0]), mu=mu,
                         tol_inner=tol_inner, admm_iters=k0, ipm_iters=0)
    return w.solve(resume=ck)
