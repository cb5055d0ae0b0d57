"""Batched LP solver, anchored-delta engine, lanes on one device.

Port of the `engine="delta"` path of `abip_tpu/parallel/batched.py`.
Every instance is a lane: a row of `(B, ...)` tensors.  The outer IPM
loop and the chunk loop run on the host.  A lane whose loop condition
is false is frozen by mask, exactly as a vmapped `while_loop` freezes
it, so each lane's result equals a one-lane solve of the same instance.
The host reads one flag per chunk ("does any lane continue?") and one
per outer iteration.

Per lane:

* setup (f64): equilibration and b/c normalization, the normal matrix
  N = rho_y I + A A', and its explicit inverse from an f32 Cholesky plus
  two f64 Newton steps; every f64 solve applies that inverse with one
  iterative-refinement step against N;
* outer loop: one barrier stage, the averaged-iterate choice, the
  hybrid mu rule and the reinit rebalance (`abip.c:2125-2277`);
* inner loop: chunks of up to `qres_period` f32 delta iterations
  (`ops.admm_delta.run_delta_chunk`, the CUDA kernel on the card), each
  followed by the f64 residual check.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import hsd
from ..ops.admm_delta import _mv, _rmv, run_delta_chunk
from ..scaling import equilibrate, normalize_bc
from ..device import resolve_device
from ..settings import Settings

f32 = torch.float32
f64 = torch.float64
i32 = torch.int32


class DeviceSolveResult(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    status: torch.Tensor       # int32: 1 solved, -1 unbounded, -2 infeasible, 0 unfinished
    ipm_iters: torch.Tensor
    admm_iters: torch.Tensor
    res_pri: torch.Tensor
    res_dual: torch.Tensor
    rel_gap: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    # raw internal state (scaled space)
    u_raw: torch.Tensor
    v_raw: torch.Tensor
    mu: torch.Tensor
    u_sum_raw: torch.Tensor
    v_sum_raw: torch.Tensor
    sj: torch.Tensor


class LaneState(NamedTuple):
    """The f64 solver state of each lane that a delta chunk consumes."""

    u: torch.Tensor       # (B, m + n + 1)
    v: torch.Tensor
    u_sum: torch.Tensor   # stage-average accumulators
    v_sum: torch.Tensor
    sj: torch.Tensor      # (B,) int32 iterations already in the sums
    qres: torch.Tensor    # (B,) f64 entry inner-criterion value


def lane_state_from_numpy(u, v, u_sum, v_sum, sj, qres, device) -> LaneState:
    """The reference's per-lane state (numpy arrays, one lane or a
    stack of lanes) as the port's `LaneState` on `device`."""
    def vec(x):
        x = np.array(x, dtype=np.float64)
        return torch.from_numpy(x.reshape(-1, x.shape[-1])).to(device)

    def lane(x, dtype):
        return torch.as_tensor(np.asarray(x).reshape(-1), dtype=dtype,
                               device=device)

    return LaneState(vec(u), vec(v), vec(u_sum), vec(v_sum),
                     lane(sj, i32), lane(qres, f64))


class _Setup(NamedTuple):
    """Loop-invariant per-lane data of one solve."""

    A_s: torch.Tensor      # (B, m, n) f64 scaled matrix
    b_s: torch.Tensor
    c_s: torch.Tensor
    N64: torch.Tensor      # (B, m, m) rho_y I + A A'
    Ninv64: torch.Tensor   # Newton-refined explicit inverse of N64
    A32: torch.Tensor      # f32 operator blocks of the kernel
    Ninv32: torch.Tensor
    h: torch.Tensor        # (B, m + n)
    g: torch.Tensor
    g_th: torch.Tensor     # (B,)
    D: torch.Tensor
    E: torch.Tensor
    sc_b: torch.Tensor
    sc_c: torch.Tensor
    pr_scale: torch.Tensor
    dr_scale: torch.Tensor
    obj_scale: torch.Tensor
    nm_b0: torch.Tensor
    nm_c0: torch.Tensor

    def solve64(self, rhs):
        """(rho_y I + A A')^-1 rhs in f64 for a `(B, m)` vector or a
        `(B, m, m)` matrix: the explicit inverse plus one refinement
        step against N64, which restores backward stability beyond the
        Newton budget (`linsys/schur._ir_apply`)."""
        if rhs.dim() == 3:
            z = self.Ninv64 @ rhs
            return z + self.Ninv64 @ (rhs - self.N64 @ z)
        z = _mv(self.Ninv64, rhs)
        return z + _mv(self.Ninv64, rhs - _mv(self.N64, z))


def setup_delta(As, bs, cs, *, rho_y=1e-3, normalize=True, scale=1.0,
                ruiz_iter=10) -> _Setup:
    """The f64 setup of the delta engine for a `(B, m, n)` stack."""
    B, m, n = As.shape
    dev = As.device
    nm_b0 = torch.linalg.vector_norm(bs, dim=-1)
    nm_c0 = torch.linalg.vector_norm(cs, dim=-1)
    if normalize:
        stg = Settings(pc_ruiz_rescale=True, origin_rescale=False,
                       qp_rescale=False, ruiz_iter=ruiz_iter, scale=scale)
        A_s, scal = equilibrate(As, stg)
        b_s, c_s, sc_b, sc_c = normalize_bc(scal, bs, cs, scale)
        D, E = scal.D, scal.E
    else:
        A_s, b_s, c_s = As, bs, cs
        D = torch.ones((B, m), dtype=f64, device=dev)
        E = torch.ones((B, n), dtype=f64, device=dev)
        sc_b = torch.ones((B,), dtype=f64, device=dev)
        sc_c = torch.ones((B,), dtype=f64, device=dev)

    eye64 = torch.eye(m, dtype=f64, device=dev).expand(B, m, m)
    N64 = rho_y * eye64 + A_s @ A_s.transpose(-1, -2)
    # explicit f64-quality inverse without f64 triangular solves: f32
    # Cholesky solves + two Newton steps X <- X + X(I - N X); each step
    # squares the residual (cond*eps32 -> its square -> f64 roundoff
    # for cond(N) up to ~1e3)
    L32 = torch.linalg.cholesky(N64.to(f32))
    X = torch.cholesky_solve(
        torch.eye(m, dtype=f32, device=dev).expand(B, m, m), L32).to(f64)
    for _ in range(2):
        X = X + X @ (eye64 - N64 @ X)
    S = _Setup(A_s=A_s, b_s=b_s, c_s=c_s, N64=N64, Ninv64=X,
               A32=A_s.to(f32).contiguous(), Ninv32=X.to(f32).contiguous(),
               h=None, g=None, g_th=None, D=D, E=E, sc_b=sc_b, sc_c=sc_c,
               pr_scale=D / (sc_b * scale)[:, None],
               dr_scale=E / (sc_c * scale)[:, None],
               obj_scale=scale * sc_c * sc_b, nm_b0=nm_b0, nm_c0=nm_c0)
    h = torch.cat([-b_s, c_s], dim=1)
    g_y = S.solve64(h[:, :m] + _mv(A_s, h[:, m:]))
    g_x = _rmv(A_s, g_y) - h[:, m:]
    g = torch.cat([g_y, -g_x], dim=1)
    return S._replace(h=h, g=g, g_th=(h * g).sum(-1))


class _Outer(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    mu: torch.Tensor
    i: torch.Tensor
    k: torch.Tensor
    final_check: torch.Tensor
    status: torch.Tensor
    res: hsd.LPResiduals
    # stage-average state, carried across chunk boundaries within a stage
    u_sum: torch.Tensor
    v_sum: torch.Tensor
    sj: torch.Tensor


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


def _select(mask, new, old):
    """Per-lane `where` over (nested) NamedTuples of `(B, ...)` tensors."""
    if isinstance(new, tuple):
        return type(new)(*[_select(mask, a, b) for a, b in zip(new, old)])
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _pick_avg(avg_crit, dom, u_sum, v_sum, u, v):
    """The averaged iterate where it is the better candidate."""
    a = avg_crit[:, None]
    return (torch.where(a, u_sum / dom[:, None], u),
            torch.where(a, v_sum / dom[:, None], v))


_NOT_PORTED = "is not ported to abip_tpu_torch yet (ROADMAP.md queue 1, item {})"


def _check_options(precision, engine, cadence, qres_period, avg_period,
                   probe_period, init_state, k_cap):
    if precision not in ("f64", "mixed"):
        raise ValueError(f"precision must be 'f64' or 'mixed'; got {precision!r}")
    if engine not in ("steps", "sprint", "delta"):
        raise ValueError(
            f"engine must be 'steps', 'sprint', or 'delta'; got {engine!r}")
    if engine == "sprint" and precision != "mixed":
        raise ValueError("engine='sprint' requires precision='mixed'")
    if qres_period < 1 or avg_period < 1 or probe_period < 1:
        raise ValueError(
            "qres_period, avg_period, and probe_period must be >= 1; got "
            f"{qres_period}, {avg_period}, {probe_period}")
    if cadence not in ("cond", "chunk"):
        raise ValueError(f"cadence must be 'cond' or 'chunk'; got {cadence!r}")
    if engine == "sprint":
        raise NotImplementedError("engine='sprint' " + _NOT_PORTED.format(18))
    if engine == "steps":
        raise NotImplementedError("engine='steps' " + _NOT_PORTED.format(19))
    if precision == "f64":
        raise NotImplementedError("precision='f64' " + _NOT_PORTED.format(19))
    if cadence == "cond":
        raise NotImplementedError("cadence='cond' " + _NOT_PORTED.format(19))
    if init_state is not None or k_cap is not None:
        raise NotImplementedError(
            "init_state/k_cap resume " + _NOT_PORTED.format(19))


def device_solve_lp(As, bs, cs, *, eps=1e-6, max_ipm=200, max_admm=200_000,
                    alpha=1.8, rho_y=1e-3, normalize=True, scale=1.0,
                    ruiz_iter=10, hybrid_thresh=1000.0, dynamic_x=0.8,
                    dynamic_eta=1.1, shrink_second=0.5, gamma0=2.0,
                    sigma0=0.3, precision="f64", solver="cholesky",
                    engine="steps", qres_period=1, avg_period=10,
                    cadence="cond", probe_period=8,
                    mu_stop=0.0, init_state=None,
                    k_cap=None) -> DeviceSolveResult:
    """Solve a `(B, m, n)` stack of standard-form LPs, one lane each.

    Defaults are the reference's (`device_solve_lp`).  This port runs
    `engine="delta"`, `precision="mixed"`, `cadence="chunk"`: each stage
    is a sequence of delta chunks of up to `qres_period` f32 iterations,
    probed every `min(probe_period, qres_period)` iterations, with the
    f64 residual check after each chunk.  Options that select another
    path raise `NotImplementedError`.  `solver` and `avg_period` are
    accepted because the reference's callers pass them; as in the
    reference, they do not act on this path.  The options of the steps
    and sprint engines (`ir_steps`, `anchor_period`, `sprint_T`,
    `sprint_mu_switch`) come with those engines (ROADMAP.md queue 1,
    items 18-19)."""
    _check_options(precision, engine, cadence, qres_period, avg_period,
                   probe_period, init_state, k_cap)
    A = As.to(f64)
    b = bs.to(f64)
    c = cs.to(f64)
    dev = A.device
    B, m, n = A.shape
    l = m + n + 1
    kcap = max_admm
    probe = min(probe_period, qres_period)

    S = setup_delta(A, b, c, rho_y=rho_y, normalize=normalize, scale=scale,
                    ruiz_iter=ruiz_iter)

    def residuals(u, v):
        return hsd.lp_residuals(
            u, v, lambda x: _mv(S.A_s, x), lambda y: _rmv(S.A_s, y),
            S.b_s, S.c_s, S.pr_scale, S.dr_scale, S.obj_scale,
            S.nm_b0, S.nm_c0, m, n)

    def inner_delta(carry: _Outer, alive):
        """One barrier stage of delta chunks (`batched.py:401-452`)."""
        mu = carry.mu
        thresh = gamma0 * mu
        s = _Inner(u=carry.u, v=carry.v, u_sum=carry.u_sum,
                   v_sum=carry.v_sum,
                   avg_crit=torch.zeros((B,), dtype=torch.bool, device=dev),
                   j=torch.zeros((B,), dtype=i32, device=dev), k=carry.k,
                   qres=torch.full((B,), torch.inf, dtype=f64, device=dev),
                   status=torch.zeros((B,), dtype=i32, device=dev),
                   res=carry.res)
        while True:
            act = alive & (s.qres >= thresh) & (s.status == 0) & (s.k < kcap)
            if not bool(act.any()):
                break
            res = run_delta_chunk(
                S.A_s, S.solve64, S.h, S.g, S.g_th, rho_y, mu, alpha,
                thresh, s.u, s.v, s.u_sum, s.v_sum, carry.sj + s.j, s.qres,
                T=qres_period, probe=probe, A32=S.A32, Ninv32=S.Ninv32,
                active=act)
            dom = torch.clamp((carry.sj + s.j + res.t_done).to(f64), min=1.0)
            r = residuals(*_pick_avg(res.avg_crit, dom, res.u_sum,
                                     res.v_sum, res.u, res.v))
            st = torch.where(
                carry.final_check,
                hsd.lp_converged_code(
                    r, eps, False, (carry.i > 0) & (s.k + res.t_done > 0)),
                0).to(i32)
            s = _select(act, _Inner(
                u=res.u, v=res.v, u_sum=res.u_sum, v_sum=res.v_sum,
                avg_crit=res.avg_crit, j=s.j + res.t_done,
                k=s.k + res.t_done, qres=res.qres, status=st, res=r), s)
        return s

    def outer_body(carry: _Outer, alive) -> _Outer:
        s = inner_delta(carry, alive)
        # adopt the averaged iterate when it is the better candidate
        # (`abip.c:2125-2129`)
        dom = torch.clamp(carry.sj + s.j, min=1).to(f64)
        u_sel, v_sel = _pick_avg(s.avg_crit, dom, s.u_sum, s.v_sum, s.u, s.v)
        r = residuals(u_sel, v_sel)
        status = torch.where(
            s.status != 0, s.status,
            hsd.lp_converged_code(r, eps, False, (carry.i > 0) & (s.k > 0)))
        final_check = carry.final_check | (carry.mu < eps)
        mu = hsd.mu_update_hybrid(carry.mu, u_sel, v_sel, m, eps,
                                  hybrid_thresh, dynamic_x, dynamic_eta,
                                  shrink_second)
        u, v = hsd.reinit_rebalance(u_sel, v_sel, sigma0, m)
        # freeze the iterate once finished
        done = status != 0
        # inner criterion unmet (ADMM cap): continue the stage from the
        # raw iterate with mu and the stage counter unchanged
        cap_exit = (s.qres >= gamma0 * carry.mu) & (status == 0)
        d, ce = done[:, None], cap_exit[:, None]
        u = torch.where(d, u_sel, torch.where(ce, s.u, u))
        v = torch.where(d, v_sel, torch.where(ce, s.v, v))
        mu = torch.where(done | cap_exit, carry.mu, mu)
        # a true stage end resets the stage-average accumulators
        zero = torch.zeros_like(s.u_sum)
        return _Outer(
            u=u, v=v, mu=mu, i=carry.i + torch.where(cap_exit, 0, 1).to(i32),
            k=s.k, final_check=final_check, status=status.to(i32), res=r,
            u_sum=torch.where(ce, s.u_sum, zero),
            v_sum=torch.where(ce, s.v_sum, zero),
            sj=torch.where(cap_exit, carry.sj + s.j, 0).to(i32))

    u0 = torch.cat([torch.zeros((B, m), dtype=f64, device=dev),
                    torch.ones((B, l - m), dtype=f64, device=dev)], dim=1)
    zl = torch.zeros((B, l), dtype=f64, device=dev)
    zi = torch.zeros((B,), dtype=i32, device=dev)
    carry = _Outer(u=u0, v=u0.clone(),
                   mu=torch.ones((B,), dtype=f64, device=dev), i=zi, k=zi,
                   final_check=torch.zeros((B,), dtype=torch.bool, device=dev),
                   status=zi, res=hsd.LPResiduals.init(B, f64, dev),
                   u_sum=zl, v_sum=zl, sj=zi)
    while True:
        alive = (carry.status == 0) & (carry.i < max_ipm) & (carry.k < kcap)
        if mu_stop > 0.0:
            alive = alive & (carry.mu >= mu_stop)
        if not bool(alive.any()):
            break
        carry = _select(alive, outer_body(carry, alive), carry)

    # -- extract + un-normalize (`get_solution`, `abip.c:1344-1414`) --------
    r = carry.res
    tau = torch.clamp(r.tau, min=hsd.EPS_TOL)[:, None]
    return DeviceSolveResult(
        x=carry.u[:, m:m + n] / tau / (S.E * S.sc_b[:, None]),
        y=carry.u[:, :m] / tau / (S.D * S.sc_c[:, None]),
        s=carry.v[:, m:m + n] / tau * S.E / (S.sc_c * scale)[:, None],
        status=carry.status, ipm_iters=carry.i, admm_iters=carry.k,
        res_pri=r.res_pri, res_dual=r.res_dual, rel_gap=r.rel_gap,
        pobj=r.ct_x_by_tau / tau[:, 0], dobj=r.bt_y_by_tau / tau[:, 0],
        u_raw=carry.u, v_raw=carry.v, mu=carry.mu,
        u_sum_raw=carry.u_sum, v_sum_raw=carry.v_sum, sj=carry.sj)


def _as_f64(x, device):
    """`x` (numpy or tensor) as an f64 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=f64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def solve_lp_batch(As, bs, cs, mesh=None, device=None,
                   **kw) -> DeviceSolveResult:
    """Solve a stacked batch of same-shape LPs.

    As: (B, m, n); bs: (B, m); cs: (B, n), numpy arrays or tensors,
    moved to `device` (default: the CUDA card; `device="cpu"` runs on
    the CPU).  Defaults to cadence="chunk".  Batches larger than `tile`
    (default 16) that it divides run as back-to-back tiles of `tile`
    lanes; tile=0 disables tiling."""
    if mesh is not None:
        raise NotImplementedError("mesh sharding " + _NOT_PORTED.format(19))
    kw.setdefault("cadence", "chunk")
    tile = kw.pop("tile", 16)
    dev = resolve_device(device)
    As, bs, cs = (_as_f64(x, dev) for x in (As, bs, cs))
    B = As.shape[0]
    if tile and B > tile and B % tile == 0:
        outs = [solve_lp_batch(As[i:i + tile], bs[i:i + tile],
                               cs[i:i + tile], tile=tile, device=dev, **kw)
                for i in range(0, B, tile)]
        return DeviceSolveResult(*[torch.cat(f) for f in zip(*outs)])
    if kw.get("engine") == "sprint2":
        raise NotImplementedError("engine='sprint2' " + _NOT_PORTED.format(18))
    kw.pop("endgame", None)   # sprint2-only knob
    return device_solve_lp(As, bs, cs, **kw)


def pad_instances(problems, dtype=torch.float64, device=None):
    """Pad a list of (A, b, c) with mixed shapes to common (M, N) stacks.

    Extra rows are 0 = 0 and extra columns get zero A columns with cost
    +1, so their optimal value is 0.  Returns (As, bs, cs, dims) with
    dims the original (m, n) per instance."""
    M = max(A.shape[0] for A, _, _ in problems)
    N = max(A.shape[1] for A, _, _ in problems)
    B = len(problems)
    As = np.zeros((B, M, N))
    bs = np.zeros((B, M))
    cs = np.ones((B, N))      # padded columns cost +1 -> forced to zero
    dims = []
    for i, (A, b, c) in enumerate(problems):
        m, n = A.shape
        As[i, :m, :n] = np.asarray(A.toarray() if hasattr(A, "toarray")
                                   else A, float)
        bs[i, :m] = b
        cs[i, :n] = c
        dims.append((m, n))
    return (*(torch.as_tensor(x, dtype=dtype, device=device)
              for x in (As, bs, cs)), dims)


def solve_lp_suite(problems, mesh=None, device=None, **kw):
    """Solve a heterogeneous list of (A, b, c) LPs as one padded batch on
    `device` (default: the CUDA card).

    Returns a list of per-instance dicts with the unpadded solutions."""
    dev = resolve_device(device)
    As, bs, cs, dims = pad_instances(problems, device=dev)
    res = solve_lp_batch(As, bs, cs, mesh=mesh, device=dev, **kw)
    out = []
    for i, (m, n) in enumerate(dims):
        out.append({
            "x": res.x[i][:n].cpu().numpy(),
            "y": res.y[i][:m].cpu().numpy(),
            "s": res.s[i][:n].cpu().numpy(),
            "status": int(res.status[i]),
            "pobj": float(res.pobj[i]),
            "dobj": float(res.dobj[i]),
            "admm_iters": int(res.admm_iters[i]),
            "res_pri": float(res.res_pri[i]),
            "rel_gap": float(res.rel_gap[i]),
        })
    return out
