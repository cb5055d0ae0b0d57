"""Segmented batched LP driver: init/solve split + streaming lane swap.

Port of `abip_tpu/parallel/segmented.py`.  `solve_lp_batch` runs until
its slowest lane converges, so one straggler idles every other lane;
this driver splits the solver into

  * ``lp_setup(As, bs, cs)`` -- each instance's equilibration, b/c
    normalization, normal-matrix inverse and HSD rank-1 data, as a lane
    stack (`LPLaneData`; the reference's ``ABIP(init)`` /
    ``ABIP(solve)`` split, `src/abip-lp/include/abip.h:116-123`);
  * ``make_segment_fn(...)(data, state)`` -- advance every lane by at
    most ``seg_chunks`` chunks of ``qres_period`` anchored-mixed ADMM
    iterations, with a fresh f64 anchor every chunk;
  * ``lp_extract(data, state)`` -- unscale + package solutions;

and ``solve_lp_stream`` swaps finished lanes' problem data for fresh
instances between segments, so no lane idles while work remains.

The reference vmaps one lane's `while_loop` over the stack; here the
segment is a host loop over chunks in which a lane whose condition is
false is frozen by mask, with one host read of "any lane running" per
chunk.  Every f32 product runs in IEEE f32 (`device.ieee_f32`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import hsd
from ..device import ieee_f32, resolve_device
from ..ops.admm_delta import _mv, _rmv
from ..scaling import equilibrate, normalize_bc
from ..settings import Settings
from .batched import _select

f32 = torch.float32
f64 = torch.float64
i32 = torch.int32

STATUS_IDLE = 99  # lane has no instance assigned (stream drained)


class LPLaneData(NamedTuple):
    """Per-instance immutable problem data (post-setup), one row per
    lane: every field has a leading lane axis."""

    A_s: torch.Tensor      # (B, m, n) equilibrated f64
    A32: torch.Tensor      # f32 copy (anchored delta products)
    Ninv32: torch.Tensor   # (B, m, m) f32 explicit (rho_y I + A A')^-1
    Ninv64: torch.Tensor   # f64 explicit inverse (anchor passes)
    N64: torch.Tensor      # (B, m, m) f64 normal matrix (refinement)
    b_s: torch.Tensor
    c_s: torch.Tensor
    h: torch.Tensor        # (B, m+n) HSD rank-1 data (`abip.c:1917-1924`)
    g: torch.Tensor
    g_th: torch.Tensor     # (B,)
    pr_scale: torch.Tensor
    dr_scale: torch.Tensor
    obj_scale: torch.Tensor
    nm_b0: torch.Tensor
    nm_c0: torch.Tensor
    D: torch.Tensor
    E: torch.Tensor
    sc_b: torch.Tensor
    sc_c: torch.Tensor


class LPLaneState(NamedTuple):
    """Mutable per-lane iterate state."""

    u: torch.Tensor
    v: torch.Tensor
    u_sum: torch.Tensor    # within-stage running sums (average candidate)
    v_sum: torch.Tensor
    j: torch.Tensor        # iterations into the current barrier stage
    k: torch.Tensor        # total ADMM iterations
    i: torch.Tensor        # barrier stages completed
    mu: torch.Tensor
    final_check: torch.Tensor
    avg_crit: torch.Tensor
    status: torch.Tensor
    res: hsd.LPResiduals


class StreamResult(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    status: torch.Tensor
    ipm_iters: torch.Tensor
    admm_iters: torch.Tensor
    res_pri: torch.Tensor
    res_dual: torch.Tensor
    rel_gap: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor


def lp_setup(As, bs, cs, rho_y=1e-3, scale=1.0, ruiz_iter=10) -> LPLaneData:
    """Each lane's init phase (`segmented.py:100-138`): pc+Ruiz
    equilibration, b/c normalization, the normal matrix's explicit
    inverse from its f64 Cholesky factor, h/g/g_th.

    The signature is lane-first by design: the reference's `lp_setup`
    takes one instance and is `vmap`ped; here `(B, m, n)`, `(B, m)`,
    `(B, n)` stacks go in and an `LPLaneData` stack comes out, the form
    the stream splices lanes into."""
    As, bs, cs = As.to(f64), bs.to(f64), cs.to(f64)
    B, m, n = As.shape
    nm_b0 = torch.linalg.vector_norm(bs, dim=-1)
    nm_c0 = torch.linalg.vector_norm(cs, dim=-1)
    stg = Settings(pc_ruiz_rescale=True, origin_rescale=False,
                   qp_rescale=False, ruiz_iter=ruiz_iter, scale=scale)
    A_s, scal = equilibrate(As, stg)
    b_s, c_s, sc_b, sc_c = normalize_bc(scal, bs, cs, scale)
    D, E = scal.D, scal.E

    eye = torch.eye(m, dtype=f64, device=As.device).expand(B, m, m)
    N64 = rho_y * eye + A_s @ A_s.transpose(-1, -2)
    Ninv64 = torch.cholesky_solve(eye, torch.linalg.cholesky(N64))
    h = torch.cat([-b_s, c_s], dim=1)
    g_y = _mv(Ninv64, h[:, :m] + _mv(A_s, h[:, m:]))
    g_x = _rmv(A_s, g_y) - h[:, m:]
    g = torch.cat([g_y, -g_x], dim=1)
    return LPLaneData(
        A_s=A_s, A32=A_s.to(f32).contiguous(),
        Ninv32=Ninv64.to(f32).contiguous(), Ninv64=Ninv64, N64=N64,
        b_s=b_s, c_s=c_s, h=h, g=g, g_th=(h * g).sum(-1),
        pr_scale=D / (sc_b * scale)[:, None],
        dr_scale=E / (sc_c * scale)[:, None],
        obj_scale=scale * sc_c * sc_b, nm_b0=nm_b0, nm_c0=nm_c0,
        D=D, E=E, sc_b=sc_b, sc_c=sc_c)


def lp_init_state(B, m, n, device=None) -> LPLaneState:
    """Cold-start state of B lanes (`update_work` cold start,
    `abip.c:1843-1927`)."""
    l = m + n + 1
    u0 = torch.cat([torch.zeros((B, m), dtype=f64, device=device),
                    torch.ones((B, l - m), dtype=f64, device=device)], dim=1)
    z = torch.zeros((B, l), dtype=f64, device=device)
    zi = torch.zeros((B,), dtype=i32, device=device)
    return LPLaneState(
        u=u0, v=u0.clone(), u_sum=z, v_sum=z.clone(), j=zi, k=zi.clone(),
        i=zi.clone(), mu=torch.ones((B,), dtype=f64, device=device),
        final_check=torch.zeros((B,), dtype=torch.bool, device=device),
        avg_crit=torch.zeros((B,), dtype=torch.bool, device=device),
        status=zi.clone(), res=hsd.LPResiduals.init(B, f64, device))


def _segment(d: LPLaneData, s: LPLaneState, *, seg_chunks, qres_period,
             eps, max_ipm, max_admm, alpha, rho_y, ir_steps, hybrid_thresh,
             dynamic_x, dynamic_eta, shrink_second, gamma0,
             sigma0) -> LPLaneState:
    """Advance every lane by at most seg_chunks chunks
    (`segmented.py:154-293`)."""
    B, m, n = d.A_s.shape
    l = m + n + 1

    def mv64(x):
        return _mv(d.A_s, x)

    def rmv64(y):
        return _rmv(d.A_s, y)

    def mv32(dx):
        return _mv(d.A32, dx.to(f32)).to(f64)

    def rmv32(dy):
        return _rmv(d.A32, dy.to(f32)).to(f64)

    def rank1_correct(u, v):
        r = u + v
        q = torch.cat([rho_y * r[:, :m], r[:, m:m + n]], dim=1)
        q = q - r[:, l - 1:] * d.h
        q = q - ((q * d.g).sum(-1) / (d.g_th + 1.0))[:, None] * d.h
        return q, r[:, l - 1]

    def residuals(u, v):
        return hsd.lp_residuals(u, v, mv64, rmv64, d.b_s, d.c_s, d.pr_scale,
                                d.dr_scale, d.obj_scale, d.nm_b0, d.nm_c0,
                                m, n)

    def chunk(s: LPLaneState) -> LPLaneState:
        # f64-quality anchor, refreshed every chunk
        x0, y0 = s.u[:, m:m + n], s.u[:, :m]
        q, _ = rank1_correct(s.u, s.v)
        w0 = -q[:, m:]
        Aw0 = mv64(w0)
        q0 = q[:, :m] + Aw0
        z0 = _mv(d.Ninv64, q0)
        Ax0, ATy0, ATz0 = mv64(x0), rmv64(y0), rmv64(z0)

        def amv(x):
            return Ax0 + mv32(x - x0)

        def armv(y):
            return ATy0 + rmv32(y - y0)

        def project(u, v):
            q, r_tau = rank1_correct(u, v)
            wx = -q[:, m:]
            rhs = q[:, :m] + Aw0 + mv32(wx - w0)
            z_y = z0 + _mv(d.Ninv32, (rhs - q0).to(f32)).to(f64)
            for _ in range(ir_steps):
                resid = rhs - _mv(d.N64, z_y)
                z_y = z_y + _mv(d.Ninv32, resid.to(f32)).to(f64)
            z_x = ATz0 + rmv32(z_y - z0) - wx
            z = torch.cat([z_y, z_x], dim=1)
            tau_t = r_tau + (z * d.h).sum(-1)
            return torch.cat([z, tau_t[:, None]], dim=1)

        def qres_of(u, v):
            return hsd.q_norm_resd(u, v, amv, armv, d.b_s, d.c_s, m, n)

        u, v, u_sum, v_sum = s.u, s.v, s.u_sum, s.v_sum
        for _ in range(qres_period):
            u, v = hsd.admm_update(u, v, u, project(u, v), s.mu, alpha, m)
            u_sum, v_sum = u_sum + u, v_sum + v
        j = s.j + qres_period
        k = s.k + qres_period

        dom = torch.clamp(j.to(f64), min=1.0)[:, None]
        q_cur = qres_of(u, v)
        u_avg, v_avg = u_sum / dom, v_sum / dom
        q_avg = qres_of(u_avg, v_avg)
        avg_crit = q_avg < q_cur
        qres = torch.where(avg_crit, q_avg, q_cur)
        ac = avg_crit[:, None]
        u_sel = torch.where(ac, u_avg, u)
        v_sel = torch.where(ac, v_avg, v)
        # the true f64 residual check, once per chunk
        r = residuals(u_sel, v_sel)
        stage_exit = qres < gamma0 * s.mu
        st = torch.where(
            s.final_check | stage_exit,
            hsd.lp_converged_code(r, eps, False, (s.i > 0) & (k > 0)),
            0).to(i32)
        done = st != 0

        # stage transition: mu update + rebalance
        final_check = s.final_check | (stage_exit & (s.mu < eps))
        mu_new = hsd.mu_update_hybrid(s.mu, u_sel, v_sel, m, eps,
                                      hybrid_thresh, dynamic_x, dynamic_eta,
                                      shrink_second)
        u_re, v_re = hsd.reinit_rebalance(u_sel, v_sel, sigma0, m)
        adv = stage_exit & ~done
        dn, av = done[:, None], adv[:, None]
        z = torch.zeros_like(u_sum)
        return LPLaneState(
            u=torch.where(dn, u_sel, torch.where(av, u_re, u)),
            v=torch.where(dn, v_sel, torch.where(av, v_re, v)),
            u_sum=torch.where(av, z, u_sum), v_sum=torch.where(av, z, v_sum),
            j=torch.where(adv, 0, j).to(i32), k=k.to(i32),
            i=(s.i + adv.to(i32)).to(i32),
            mu=torch.where(adv, mu_new, s.mu), final_check=final_check,
            avg_crit=avg_crit, status=st, res=r)

    with ieee_f32():
        for _ in range(seg_chunks):
            act = (s.status == 0) & (s.k < max_admm) & (s.i < max_ipm)
            if not bool(act.any()):
                break
            s = _select(act, chunk(s), s)
    return s


def make_segment_fn(*, seg_chunks=32, qres_period=64, eps=1e-6, max_ipm=200,
                    max_admm=200_000, alpha=1.8, rho_y=1e-3, ir_steps=1,
                    hybrid_thresh=1000.0, dynamic_x=0.8, dynamic_eta=1.1,
                    shrink_second=0.5, gamma0=2.0, sigma0=0.3):
    """(data, state) -> state advancing every lane one segment."""
    opts = dict(seg_chunks=seg_chunks, qres_period=qres_period, eps=eps,
                max_ipm=max_ipm, max_admm=max_admm, alpha=alpha,
                rho_y=rho_y, ir_steps=ir_steps, hybrid_thresh=hybrid_thresh,
                dynamic_x=dynamic_x, dynamic_eta=dynamic_eta,
                shrink_second=shrink_second, gamma0=gamma0, sigma0=sigma0)

    def segment(data: LPLaneData, state: LPLaneState) -> LPLaneState:
        return _segment(data, state, **opts)

    return segment


def lp_extract(d: LPLaneData, s: LPLaneState) -> StreamResult:
    """Unscale + package a lane stack (`get_solution`,
    `abip.c:1344-1414`); `lp_setup` fixes scale=1 in the stream."""
    m, n = d.A_s.shape[1:]
    r = s.res
    tau = torch.clamp(r.tau, min=hsd.EPS_TOL)
    t = tau[:, None]
    return StreamResult(
        x=s.u[:, m:m + n] / t / (d.E * d.sc_b[:, None]),
        y=s.u[:, :m] / t / (d.D * d.sc_c[:, None]),
        s=s.v[:, m:m + n] / t * d.E / d.sc_c[:, None],
        status=s.status, ipm_iters=s.i, admm_iters=s.k,
        res_pri=r.res_pri, res_dual=r.res_dual, rel_gap=r.rel_gap,
        pobj=r.ct_x_by_tau / tau, dobj=r.bt_y_by_tau / tau)


def _splice(stack, lane, new):
    """stack[lane] = new[0] in every field (an indexed assignment)."""
    for a, b in zip(stack, new):
        if isinstance(a, tuple):
            _splice(a, lane, b)
        else:
            a[lane] = b[0]


def _own(stack):
    """A stack whose fields are distinct, writable tensors."""
    return type(stack)(*[_own(f) if isinstance(f, tuple) else f.clone()
                         for f in stack])


def solve_lp_stream(problems, B=8, seg_chunks=32, rho_y=1e-3, device=None,
                    **kw):
    """Stream a suite of same-shape LPs through B pipelined lanes on
    `device` (default: the CUDA card).

    problems: list of (A, b, c) with a common (m, n).  Returns (results,
    info): per-instance dicts in input order, and aggregate stats.  A
    finished lane is refilled with the next pending instance after the
    segment in which it finished; once the suite is drained, a finished
    lane is parked (status STATUS_IDLE, frozen)."""
    if not problems:
        return [], {}
    m, n = problems[0][0].shape
    for A, _, _ in problems:
        if A.shape != (m, n):
            raise ValueError("solve_lp_stream needs same-shape instances; "
                             f"got {A.shape} vs {(m, n)}")
    dev = resolve_device(device)
    N = len(problems)
    B = min(B, N)
    eps = kw.get("eps", 1e-6)
    max_admm = kw.get("max_admm", 200_000)
    max_ipm = kw.get("max_ipm", 200)
    segment = make_segment_fn(seg_chunks=seg_chunks, rho_y=rho_y, **kw)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=dev)[None]

    def setup(i):
        A, b, c = problems[i]
        return lp_setup(t(A), t(b), t(c), rho_y=rho_y)

    lanes = [setup(i) for i in range(B)]
    data = LPLaneData(*[torch.cat(f) for f in zip(*lanes)])
    state0 = lp_init_state(1, m, n, dev)
    state = _own(LPLaneState(*[
        hsd.LPResiduals(*[x.expand(B) for x in f]) if isinstance(f, tuple)
        else f.expand((B,) + f.shape[1:]) for f in state0]))
    idle = state0._replace(status=torch.full((1,), STATUS_IDLE, dtype=i32,
                                             device=dev))
    lane_inst = list(range(B))
    next_idx = B
    results = [None] * N
    segments = 0

    while True:
        state = segment(data, state)
        segments += 1
        st, k, i = (x.tolist() for x in torch.stack(
            [state.status, state.k, state.i]).cpu())
        finished = [ln for ln in range(B)
                    if lane_inst[ln] is not None
                    and (st[ln] != 0 or k[ln] >= max_admm
                         or i[ln] >= max_ipm)]
        if finished:
            out = lp_extract(data, state)
            for ln in finished:
                idx = lane_inst[ln]
                head = torch.stack([out.pobj[ln], out.dobj[ln],
                                    out.res_pri[ln], out.rel_gap[ln]]).tolist()
                results[idx] = {
                    "x": out.x[ln].cpu().numpy(),
                    "y": out.y[ln].cpu().numpy(),
                    "s": out.s[ln].cpu().numpy(),
                    "status": int(st[ln]), "admm_iters": int(k[ln]),
                    "ipm_iters": int(i[ln]), "pobj": head[0],
                    "dobj": head[1], "res_pri": head[2], "rel_gap": head[3],
                }
                if next_idx < N:
                    _splice(data, ln, setup(next_idx))
                    _splice(state, ln, state0)
                    lane_inst[ln] = next_idx
                    next_idx += 1
                else:
                    # park the lane: a nonzero status freezes it
                    _splice(state, ln, idle)
                    lane_inst[ln] = None
        if all(r is not None for r in results):
            break
    info = {"segments": segments, "B": B, "seg_chunks": seg_chunks,
            "eps": eps,
            "total_admm_iters": int(sum(r["admm_iters"] for r in results)),
            "solved": int(sum(r["status"] == 1 for r in results))}
    return results, info
