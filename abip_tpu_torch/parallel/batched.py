"""Batched LP solver, lanes on one device.

Port of `abip_tpu/parallel/batched.py`.  Every instance
is a lane: a row of `(B, ...)` tensors.  The outer IPM loop, the stage
loop and the chunk loops run on the host.  A lane whose loop condition
is false is frozen by mask, exactly as a vmapped `while_loop` freezes
it, so each lane's result equals a one-lane solve of the same instance;
since a frozen lane stays frozen, the host reads "does any lane
continue?" only every few iterations where an iteration is short.

Per lane:

* setup (f64): equilibration and b/c normalization, the normal matrix
  N = rho_y I + A A' and its factor: for the delta engine an explicit
  inverse from an f32 Cholesky plus two f64 Newton steps (every f64
  solve applies it with one refinement step against N); for the steps
  and sprint engines the f64 Cholesky, with its f32 copy or the f32
  explicit inverse (`solver`) for the anchored f32 solves, and the f32
  inverse the sprint kernels apply;
* outer loop: one barrier stage, the averaged-iterate choice, the
  hybrid mu rule and the reinit rebalance (`abip.c:2125-2277`);
* a stage, by engine:
  - "delta": chunks of up to `qres_period` f32 delta iterations
    (`ops.admm_delta.run_delta_chunk`, kernel K1 on the card), each
    followed by the f64 residual check;
  - "steps": ADMM iterations in f64, or (precision "mixed") through
    f32 deltas from a per-stage anchor with `ir_steps` refinement steps
    against N; cadence "cond" checks every `qres_period`/`avg_period`
    iterations, cadence "chunk" runs micro-trips of `probe_period`
    iterations with the inner criterion after each and the f64
    residual check once per chunk;
  - "sprint": "steps" with the bulk (mu > `sprint_mu_switch`) in pure
    f32 sprints: `sprint_T` iterations per launch of K7
    (`ops.admm_sprint.fused_admm_sprint`) under cadence "cond", one
    chunk per launch of K6 (`fused_admm_sprint_stop`) under "chunk".

`solve_lp_batch(engine="sprint2")` runs two of these programs: the
sprint engine to the mu switch, then "steps" or "delta" (`endgame`) on
the unfinished lanes; above B=32 lanes in compacted rounds.

With a `mesh` (`solve_lp_batch`, `solve_lp_suite`) the lanes split over
the mesh's ranks, each rank solving its share on its own device, and
the results are all-gathered in lane order (`parallel.sharded`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import hsd
from ..ops.admm_delta import _mv, _rmv, run_delta_chunk
from ..ops.admm_sprint import fused_admm_sprint, fused_admm_sprint_stop
from ..scaling import equilibrate, normalize_bc
from ..device import resolve_device
from ..settings import Settings
from ..utils.profiling import annotate, host_read

f32 = torch.float32
f64 = torch.float64
i32 = torch.int32

# cadence "cond": iterations between two host reads of "any lane alive"
_COND_SYNC = 16


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
    # raw internal state (scaled space), for the phase hand-off
    # (mu_stop / init_state)
    u_raw: torch.Tensor = None
    v_raw: torch.Tensor = None
    mu: torch.Tensor = None
    u_sum_raw: torch.Tensor = None
    v_sum_raw: torch.Tensor = None
    sj: torch.Tensor = None


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
    Ninv64: torch.Tensor   # delta: Newton-refined explicit inverse of N64
    chol64: torch.Tensor   # steps/sprint: f64 Cholesky factor of N64
    A32: torch.Tensor      # f32 operator blocks
    Ninv32: torch.Tensor   # f32 explicit inverse (delta, sprint, "inverse")
    chol32: torch.Tensor   # f32 Cholesky factor (steps, "cholesky")
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
        `(B, m, m)` matrix: through the f64 Cholesky factor, or the
        explicit inverse plus one refinement step against N64, which
        restores backward stability beyond the Newton budget
        (`linsys/schur._ir_apply`)."""
        if self.chol64 is not None:
            if rhs.dim() == 3:
                return torch.cholesky_solve(rhs, self.chol64)
            return torch.cholesky_solve(rhs[..., None], self.chol64)[..., 0]
        if rhs.dim() == 3:
            z = self.Ninv64 @ rhs
            return z + self.Ninv64 @ (rhs - self.N64 @ z)
        z = _mv(self.Ninv64, rhs)
        return z + _mv(self.Ninv64, rhs - _mv(self.N64, z))

    def solve32(self, r32):
        """N^-1 r in f32, `(B, m)`: the f32 Cholesky factor or the f32
        explicit inverse (`solver`)."""
        if self.chol32 is not None:
            return torch.cholesky_solve(r32[..., None], self.chol32)[..., 0]
        return _mv(self.Ninv32, r32)


def _setup(As, bs, cs, *, factor, rho_y, normalize, scale, ruiz_iter,
           sprint=False, solver="inverse") -> _Setup:
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
    Ninv64 = chol64 = Ninv32 = chol32 = None
    if factor == "newton":
        # explicit f64-quality inverse without f64 triangular solves: f32
        # Cholesky solves + two Newton steps X <- X + X(I - N X); each
        # step squares the residual (cond*eps32 -> its square -> f64
        # roundoff for cond(N) up to ~1e3)
        L32 = torch.linalg.cholesky(N64.to(f32))
        X = torch.cholesky_solve(
            torch.eye(m, dtype=f32, device=dev).expand(B, m, m), L32).to(f64)
        for _ in range(2):
            X = X + X @ (eye64 - N64 @ X)
        Ninv64, Ninv32 = X, X.to(f32).contiguous()
    else:
        chol64 = torch.linalg.cholesky(N64)
        if sprint or solver == "inverse":
            # the sprint kernels apply N^-1 as one product; solver
            # "inverse" makes every f32 solve one product too
            Ninv32 = torch.cholesky_solve(eye64, chol64).to(f32).contiguous()
        if solver != "inverse":
            chol32 = chol64.to(f32)
    S = _Setup(A_s=A_s, b_s=b_s, c_s=c_s, N64=N64, Ninv64=Ninv64,
               chol64=chol64, A32=A_s.to(f32).contiguous(), Ninv32=Ninv32,
               chol32=chol32, h=None, g=None, g_th=None, D=D, E=E,
               sc_b=sc_b, sc_c=sc_c, pr_scale=D / (sc_b * scale)[:, None],
               dr_scale=E / (sc_c * scale)[:, None],
               obj_scale=scale * sc_c * sc_b, nm_b0=nm_b0, nm_c0=nm_c0)
    h = torch.cat([-b_s, c_s], dim=1)
    g_y = S.solve64(h[:, :m] + _mv(A_s, h[:, m:]))
    g_x = _rmv(A_s, g_y) - h[:, m:]
    g = torch.cat([g_y, -g_x], dim=1)
    return S._replace(h=h, g=g, g_th=(h * g).sum(-1))


def setup_delta(As, bs, cs, *, rho_y=1e-3, normalize=True, scale=1.0,
                ruiz_iter=10) -> _Setup:
    """The f64 setup of the delta engine for a `(B, m, n)` stack."""
    return _setup(As, bs, cs, factor="newton", rho_y=rho_y,
                  normalize=normalize, scale=scale, ruiz_iter=ruiz_iter)


def setup_steps(As, bs, cs, *, rho_y=1e-3, normalize=True, scale=1.0,
                ruiz_iter=10, sprint=False, solver="cholesky") -> _Setup:
    """The f64 setup of the steps and sprint engines
    (`batched.py:233-256`): the f64 Cholesky factor of N; `solver`
    "cholesky" solves f32 systems with its f32 copy, "inverse" with the
    f32 explicit inverse; `sprint` adds that inverse for the kernels."""
    return _setup(As, bs, cs, factor="cholesky", rho_y=rho_y,
                  normalize=normalize, scale=scale, ruiz_iter=ruiz_iter,
                  sprint=sprint, solver=solver)


class _Anchor(NamedTuple):
    """Per-stage anchor of the mixed-precision operators."""

    x0: torch.Tensor    # (B, n) matvec operand anchor
    y0: torch.Tensor    # (B, m) rmatvec operand anchor
    Ax0: torch.Tensor   # f64 A x0
    ATy0: torch.Tensor  # f64 A' y0
    w0: torch.Tensor    # (B, n) rhs-fold operand anchor
    Aw0: torch.Tensor   # f64 A w0
    z0: torch.Tensor    # (B, m) KKT solution anchor
    ATz0: torch.Tensor  # f64 A' z0
    q0: torch.Tensor    # (B, m) normal-equations rhs anchor


class _Outer(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    mu: torch.Tensor
    i: torch.Tensor
    k: torch.Tensor
    final_check: torch.Tensor
    status: torch.Tensor
    res: hsd.LPResiduals
    # stage-average state, carried across anchor re-caps and chunk
    # boundaries within a stage
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
        out = [_select(mask, a, b) for a, b in zip(new, old)]
        return type(new)(*out) if hasattr(new, "_fields") else tuple(out)
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _pick_avg(avg_crit, dom, u_sum, v_sum, u, v):
    """The averaged iterate where it is the better candidate."""
    a = avg_crit[:, None]
    return (torch.where(a, u_sum / dom[:, None], u),
            torch.where(a, v_sum / dom[:, None], v))


def _check_options(precision, engine, cadence, qres_period, avg_period,
                   anchor_period, probe_period):
    """The reference's option checks (`batched.py:174-194`)."""
    if precision not in ("f64", "mixed"):
        raise ValueError(f"precision must be 'f64' or 'mixed'; got {precision!r}")
    if engine not in ("steps", "sprint", "delta"):
        raise ValueError(
            f"engine must be 'steps', 'sprint', or 'delta'; got {engine!r}")
    if engine == "sprint" and precision != "mixed":
        raise ValueError("engine='sprint' requires precision='mixed'")
    if engine == "delta" and cadence != "chunk":
        raise ValueError("engine='delta' requires cadence='chunk'")
    if qres_period < 1 or avg_period < 1 or anchor_period < 1 \
            or probe_period < 1:
        raise ValueError(
            "qres_period, avg_period, anchor_period, and probe_period must "
            f"be >= 1; got {qres_period}, {avg_period}, {anchor_period}, "
            f"{probe_period}")
    if cadence not in ("cond", "chunk"):
        raise ValueError(f"cadence must be 'cond' or 'chunk'; got {cadence!r}")


def _any(mask) -> bool:
    """Whether any lane of `mask` is set: a read of the device."""
    with host_read():
        return bool(mask.any())


def _lanes_i32(x, B, dev):
    return torch.as_tensor(x, device=dev).to(i32).expand(B).clone()


def device_solve_lp(As, bs, cs, **opts) -> DeviceSolveResult:
    """Solve one standard-form LP (A `(m, n)`, b `(m,)`, c `(n,)`
    tensors), as the reference's `device_solve_lp` does, or a `(B, m, n)`
    stack, one lane each (the reference's `vmap` of it).  One instance
    runs as a lane of its own and its fields come back without the lane
    axis.  The options are `_device_solve_lanes`'s."""
    with annotate("lp_batch.solve") as span:
        r = _device_solve(As, bs, cs, **opts)
        span.note(admm_iters=r.admm_iters)
        return r


def _device_solve(As, bs, cs, **opts) -> DeviceSolveResult:
    if As.dim() == 2:
        r = _device_solve_lanes(As[None], bs[None], cs[None], **opts)
        return DeviceSolveResult(*(None if f is None else f[0] for f in r))
    return _device_solve_lanes(As, bs, cs, **opts)


def _device_solve_lanes(As, bs, cs, *, eps=1e-6, max_ipm=200,
                        max_admm=200_000, alpha=1.8, rho_y=1e-3,
                        normalize=True, scale=1.0, ruiz_iter=10,
                        hybrid_thresh=1000.0, dynamic_x=0.8, dynamic_eta=1.1,
                        shrink_second=0.5, gamma0=2.0, sigma0=0.3,
                        precision="f64", ir_steps=1, solver="cholesky",
                        engine="steps", sprint_T=32, sprint_mu_switch=1e-3,
                        qres_period=1, anchor_period=1000, avg_period=10,
                        cadence="cond", probe_period=8, mu_stop=0.0,
                        init_state=None, k_cap=None) -> DeviceSolveResult:
    """Solve a `(B, m, n)` stack of standard-form LPs, one lane each.

    Options and defaults are the reference's (`device_solve_lp`, whose
    docstring gives their semantics).  `init_state` resumes each lane
    from the reference's 6-tuple (u, v, mu, k, i, status) at a stage
    boundary or 9-tuple (adding u_sum, v_sum, sj) mid-stage; `k_cap`
    (an int or `(B,)` ints) caps the total ADMM count below
    `max_admm`."""
    _check_options(precision, engine, cadence, qres_period, avg_period,
                   anchor_period, probe_period)
    A = As.to(f64)
    b = bs.to(f64)
    c = cs.to(f64)
    dev = A.device
    B, m, n = A.shape
    l = m + n + 1
    mixed = precision == "mixed"
    sprint = engine == "sprint"
    delta = engine == "delta"
    chunked = cadence == "chunk"
    kcap = _lanes_i32(max_admm, B, dev)
    if k_cap is not None:
        kcap = torch.minimum(kcap, _lanes_i32(k_cap, B, dev))
    probe = min(probe_period, qres_period)
    # mixed mode caps each stage's trips per anchor; f64 needs no anchor
    stage_cap = anchor_period if mixed else max_admm

    with annotate("lp_batch.setup"):
        if delta:
            S = setup_delta(A, b, c, rho_y=rho_y, normalize=normalize,
                            scale=scale, ruiz_iter=ruiz_iter)
        else:
            S = setup_steps(A, b, c, rho_y=rho_y, normalize=normalize,
                            scale=scale, ruiz_iter=ruiz_iter, sprint=sprint,
                            solver=solver)

    def mv64(x):
        return _mv(S.A_s, x)

    def rmv64(y):
        return _rmv(S.A_s, y)

    def residuals(u, v):
        return hsd.lp_residuals(u, v, mv64, rmv64, S.b_s, S.c_s, S.pr_scale,
                                S.dr_scale, S.obj_scale, S.nm_b0, S.nm_c0,
                                m, n)

    def rank1_correct(u, v):
        """The rhs build of `project_lin_sys` (`abip.c:539-558`)."""
        r = u + v
        q = torch.cat([rho_y * r[:, :m], r[:, m:m + n]], dim=1)
        q = q - r[:, l - 1:] * S.h
        q = q - ((q * S.g).sum(-1) / (S.g_th + 1.0))[:, None] * S.h
        return q, r[:, l - 1]

    def make_anchor(u, v) -> _Anchor:
        """One f64-quality pass per barrier stage."""
        x0, y0 = u[:, m:m + n], u[:, :m]
        q, _ = rank1_correct(u, v)
        w0 = -q[:, m:]
        Aw0 = mv64(w0)
        q0 = q[:, :m] + Aw0
        z0 = S.solve64(q0)
        return _Anchor(x0=x0, y0=y0, Ax0=mv64(x0), ATy0=rmv64(y0), w0=w0,
                       Aw0=Aw0, z0=z0, ATz0=rmv64(z0), q0=q0)

    def make_ops(anc: _Anchor):
        """(matvec, rmatvec, project) of one stage: direct f64, or f32
        deltas from the stage anchor."""
        if not mixed:
            def project(u, v):
                q, r_tau = rank1_correct(u, v)
                wx = -q[:, m:]
                z_y = S.solve64(q[:, :m] + mv64(wx))
                z = torch.cat([z_y, rmv64(z_y) - wx], dim=1)
                tau_t = r_tau + (z * S.h).sum(-1)
                return torch.cat([z, tau_t[:, None]], dim=1)

            return mv64, rmv64, project

        def mv32(dx):
            return _mv(S.A32, dx.to(f32)).to(f64)

        def rmv32(dy):
            return _rmv(S.A32, dy.to(f32)).to(f64)

        def amv(x):
            return anc.Ax0 + mv32(x - anc.x0)

        def armv(y):
            return anc.ATy0 + rmv32(y - anc.y0)

        def project(u, v):
            q, r_tau = rank1_correct(u, v)
            wx = -q[:, m:]
            rhs = q[:, :m] + anc.Aw0 + mv32(wx - anc.w0)
            z_y = anc.z0 + S.solve32((rhs - anc.q0).to(f32)).to(f64)
            for _ in range(ir_steps):
                resid = rhs - _mv(S.N64, z_y)
                z_y = z_y + S.solve32(resid.to(f32)).to(f64)
            z_x = anc.ATz0 + rmv32(z_y - anc.z0) - wx
            z = torch.cat([z_y, z_x], dim=1)
            tau_t = r_tau + (z * S.h).sum(-1)
            return torch.cat([z, tau_t[:, None]], dim=1)

        return amv, armv, project

    def stage_start(carry: _Outer) -> _Inner:
        """The stage's inner state: the outer carry's iterate and stage
        sums (nonzero after a cap exit), j = 0, qres = inf."""
        return _Inner(u=carry.u, v=carry.v, u_sum=carry.u_sum,
                      v_sum=carry.v_sum,
                      avg_crit=torch.zeros((B,), dtype=torch.bool,
                                           device=dev),
                      j=torch.zeros((B,), dtype=i32, device=dev), k=carry.k,
                      qres=torch.full((B,), torch.inf, dtype=f64, device=dev),
                      status=torch.zeros((B,), dtype=i32, device=dev),
                      res=carry.res)

    def checked(carry, s, u, v, u_sum, v_sum, dj, dk, qres, avg_crit):
        """The f64 residual check at a chunk's end (`batched.py:591-606`)."""
        dom = torch.clamp((carry.sj + s.j + dj).to(f64), min=1.0)
        r = residuals(*_pick_avg(avg_crit, dom, u_sum, v_sum, u, v))
        st = torch.where(
            carry.final_check,
            hsd.lp_converged_code(r, eps, False,
                                  (carry.i > 0) & (s.k + dk > 0)), 0).to(i32)
        return _Inner(u=u, v=v, u_sum=u_sum, v_sum=v_sum, avg_crit=avg_crit,
                      j=s.j + dj, k=s.k + dk, qres=qres, status=st, res=r)

    def inner_delta(carry: _Outer, alive):
        """One barrier stage of delta chunks (`batched.py:401-452`)."""
        mu = carry.mu
        thresh = gamma0 * mu
        s = stage_start(carry)
        while True:
            act = alive & (s.qres >= thresh) & (s.status == 0) & (s.k < kcap)
            if not _any(act):
                break
            with annotate("lp_batch.chunk"):
                res = run_delta_chunk(
                    S.A_s, S.solve64, S.h, S.g, S.g_th, rho_y, mu, alpha,
                    thresh, s.u, s.v, s.u_sum, s.v_sum, carry.sj + s.j,
                    s.qres, T=qres_period, probe=probe, A32=S.A32,
                    Ninv32=S.Ninv32, active=act)
                with annotate("lp_batch.check"):
                    new = checked(carry, s, res.u, res.v, res.u_sum,
                                  res.v_sum, res.t_done, res.t_done, res.qres,
                                  res.avg_crit)
                s = _select(act, new, s)
        return s

    def inner(carry: _Outer, alive):
        """One barrier stage of the steps or sprint engine
        (`batched.py:454-689`)."""
        mu = carry.mu
        thresh = gamma0 * mu
        anc = make_anchor(carry.u, carry.v) if mixed else None
        mv, rmv, project = make_ops(anc)

        def qres_of(u, v):
            return hsd.q_norm_resd(u, v, mv, rmv, S.b_s, S.c_s, m, n)

        def step(u, v):
            return hsd.admm_update(u, v, u, project(u, v), mu, alpha, m)

        # the sprint lanes of this stage (mu is fixed within it): one host
        # read per stage tells which kernels the stage needs
        if sprint and not (chunked and mu_stop >= sprint_mu_switch):
            sp = mu > sprint_mu_switch
            use_sp, use_st = _any(alive & sp), _any(alive & ~sp)
        else:
            sp = torch.full((B,), sprint, dtype=torch.bool, device=dev)
            use_sp, use_st = sprint, not sprint
        h32, g32 = S.h.to(f32), S.g.to(f32)

        def cond_active(s):
            return (alive & (s.qres >= thresh) & (s.status == 0)
                    & (s.k < kcap) & (s.j < stage_cap))

        def steps_chunk(s: _Inner, act) -> _Inner:
            """Micro-trips of `probe` iterations, each followed by the
            inner criterion on the current and averaged iterate."""
            z = torch.zeros((B,), dtype=i32, device=dev)
            t = (s.u, s.v, s.u_sum, s.v_sum, z, z, s.qres, s.avg_crit)
            while True:
                u, v, us, vs, dj, dk, q, ac = t
                mc = (act & (q >= thresh) & (dk < qres_period)
                      & (s.j + dj < stage_cap) & (s.k + dk < kcap))
                if not _any(mc):
                    break
                for _ in range(probe):
                    u, v = step(u, v)
                    us, vs = us + u, vs + v
                dj, dk = dj + probe, dk + probe
                dom = torch.clamp((carry.sj + s.j + dj).to(f64), min=1.0)
                q_cur = qres_of(u, v)
                q_avg = qres_of(us / dom[:, None], vs / dom[:, None])
                ac = q_avg < q_cur
                t = _select(mc, (u, v, us, vs, dj, dk,
                                 torch.where(ac, q_avg, q_cur), ac), t)
            return checked(carry, s, *t)

        def sprint_chunk(s: _Inner, act) -> _Inner:
            """The whole chunk in one K6 launch; the average is
            accumulated once (dj = 1) and never adopted
            (`batched.py:644-667`)."""
            u32, v32, t_done, q32 = fused_admm_sprint_stop(
                S.A32, S.Ninv32, h32, g32, rho_y, S.g_th, mu, alpha, thresh,
                s.u.to(f32), s.v.to(f32), T=qres_period, probe=probe,
                active=act)
            u, v = u32.to(f64), v32.to(f64)
            return checked(carry, s, u, v, s.u_sum + u, s.v_sum + v,
                           torch.ones((B,), dtype=i32, device=dev), t_done,
                           q32.to(f64), torch.zeros_like(s.avg_crit))

        s = stage_start(carry)
        if chunked:
            while True:
                act = cond_active(s)
                if not _any(act):
                    break
                if use_sp and use_st:
                    new = _select(sp, sprint_chunk(s, act & sp),
                                  steps_chunk(s, act & ~sp))
                elif use_sp:
                    new = sprint_chunk(s, act)
                else:
                    new = steps_chunk(s, act)
                s = _select(act, new, s)
            return s

        # cadence "cond": one iteration (or one K7 sprint) per trip.  All
        # lanes start the stage at j = 0 and a lane stops advancing only
        # when frozen, so every live lane's j + 1 is the trip number `jp`
        # and the check cadence is known on the host.
        jp = 0
        while True:
            act = cond_active(s)
            if jp % _COND_SYNC == 0 and not _any(act):
                break
            jp += 1
            if use_st:
                u, v = step(s.u, s.v)
                dk = torch.ones((B,), dtype=i32, device=dev)
            if use_sp:
                u32, v32 = fused_admm_sprint(
                    S.A32, S.Ninv32, h32, g32, rho_y, S.g_th, mu, alpha,
                    s.u.to(f32), s.v.to(f32), T=sprint_T, active=act & sp)
                if use_st:
                    u = torch.where(sp[:, None], u32.to(f64), u)
                    v = torch.where(sp[:, None], v32.to(f64), v)
                    dk = torch.where(sp, sprint_T, dk).to(i32)
                else:
                    u, v = u32.to(f64), v32.to(f64)
                    dk = torch.full((B,), sprint_T, dtype=i32, device=dev)
            u_sum, v_sum = s.u_sum + u, s.v_sum + v
            dom = (carry.sj + s.j + 1).to(f64)
            qres, avg_crit = s.qres, s.avg_crit
            if qres_period == 1 or jp % qres_period == 0 \
                    or jp % avg_period == 0:
                qres = qres_of(u, v)
                avg_crit = torch.zeros_like(s.avg_crit)
                if jp % avg_period == 0:
                    q_avg = qres_of(u_sum / dom[:, None], v_sum / dom[:, None])
                    avg_crit = q_avg < qres
                    qres = torch.where(avg_crit, q_avg, qres)
            r, st = s.res, torch.zeros((B,), dtype=i32, device=dev)
            if not mixed or jp % avg_period == 0:
                # true f64 products for the check, never the anchored
                # deltas (`batched.py:546-559`)
                r_new = residuals(*_pick_avg(avg_crit, dom, u_sum, v_sum, u,
                                             v))
                st_new = hsd.lp_converged_code(r_new, eps, False,
                                               (carry.i > 0) & (s.k > 0))
                r = _select(carry.final_check, r_new, s.res)
                st = torch.where(carry.final_check, st_new, 0).to(i32)
            s = _select(act, _Inner(u=u, v=v, u_sum=u_sum, v_sum=v_sum,
                                    avg_crit=avg_crit, j=s.j + 1,
                                    k=s.k + dk, qres=qres, status=st,
                                    res=r), s)
        return s

    def outer_body(carry: _Outer, alive) -> _Outer:
        """One IPM iteration of the `alive` lanes; the others keep
        `carry`."""
        with annotate("lp_batch.stage"):
            s = (inner_delta if delta else inner)(carry, alive)
        with annotate("lp_batch.outer"):
            return _select(alive, outer_step(carry, s), carry)

    def outer_step(carry: _Outer, s: _Inner) -> _Outer:
        """The IPM update after stage `s`: the pick, the residuals, the
        mu rule and the reinit."""
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
        # inner criterion unmet (anchor or ADMM cap): continue the stage
        # from the raw iterate with mu and the stage counter unchanged
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

    zl = torch.zeros((B, l), dtype=f64, device=dev)
    zi = torch.zeros((B,), dtype=i32, device=dev)
    if init_state is None:
        u0 = torch.cat([torch.zeros((B, m), dtype=f64, device=dev),
                        torch.ones((B, l - m), dtype=f64, device=dev)], dim=1)
        carry = _Outer(u=u0, v=u0.clone(),
                       mu=torch.ones((B,), dtype=f64, device=dev), i=zi, k=zi,
                       final_check=torch.zeros((B,), dtype=torch.bool,
                                               device=dev),
                       status=zi, res=hsd.LPResiduals.init(B, f64, dev),
                       u_sum=zl, v_sum=zl, sj=zi)
    else:
        def t64(x):
            return torch.as_tensor(x, device=dev).to(f64)

        if len(init_state) == 6:
            # a hand-off at a stage boundary: the stage sums are zero
            u_i, v_i, mu_i, k_i, i_i, st_i = init_state
            us_i, vs_i, sj_i = zl, zl, zi
        else:
            # a mid-stage resume: the stage average survives the hand-off
            u_i, v_i, mu_i, k_i, i_i, st_i, us_i, vs_i, sj_i = init_state
        mu_i = t64(mu_i).reshape(B)
        carry = _Outer(u=t64(u_i).reshape(B, l), v=t64(v_i).reshape(B, l),
                       mu=mu_i, i=_lanes_i32(i_i, B, dev),
                       k=_lanes_i32(k_i, B, dev), final_check=mu_i < eps,
                       status=_lanes_i32(st_i, B, dev),
                       res=hsd.LPResiduals.init(B, f64, dev),
                       u_sum=t64(us_i).reshape(B, l),
                       v_sum=t64(vs_i).reshape(B, l),
                       sj=_lanes_i32(sj_i, B, dev))
    while True:
        alive = (carry.status == 0) & (carry.i < max_ipm) & (carry.k < kcap)
        if mu_stop > 0.0:
            # phase-boundary exit: stop (status 0, state returned) once
            # the barrier passes mu_stop, so another engine can continue
            alive = alive & (carry.mu >= mu_stop)
        if not _any(alive):
            break
        carry = outer_body(carry, alive)

    # -- extract + un-normalize (`get_solution`, `abip.c:1344-1414`) --------
    with annotate("lp_batch.extract"):
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
    lanes; tile=0 disables tiling.  engine="sprint2" runs the two-phase
    driver (`_solve_lp_batch_twophase`).

    `mesh`, the stand-in for the reference's JAX `Mesh` with a "batch"
    axis, is a 1-D `torch.distributed.device_mesh.DeviceMesh` with that
    axis on `device`'s type.  The call is SPMD: every rank of the mesh
    makes it with the same whole batch, rank r solves lanes
    [r B/p, (r+1) B/p) on its own device, untiled and (sprint2) without
    compaction, as the reference's mesh path runs, and every rank
    returns the whole batch, all-gathered in lane order
    (`parallel.sharded.lanes_over_mesh`).  B must be divisible by the
    mesh size."""
    kw.setdefault("cadence", "chunk")
    tile = kw.pop("tile", 16)
    dev = resolve_device(device)
    with annotate("lp_batch.solve") as span:
        with annotate("lp_batch.upload"):
            As, bs, cs = (_as_f64(x, dev) for x in (As, bs, cs))
        if mesh is not None:
            from .sharded import lanes_over_mesh

            out = lanes_over_mesh(
                mesh, dev, (As, bs, cs),
                lambda *share: _solve_whole(*share, whole=True, **kw))
        elif tile and As.shape[0] > tile and As.shape[0] % tile == 0:
            outs = [solve_lp_batch(As[i:i + tile], bs[i:i + tile],
                                   cs[i:i + tile], tile=tile, device=dev,
                                   **kw)
                    for i in range(0, As.shape[0], tile)]
            out = DeviceSolveResult(*[torch.cat(f) for f in zip(*outs)])
        else:
            out = _solve_whole(As, bs, cs, **kw)
        span.note(admm_iters=out.admm_iters)
        return out


def _solve_whole(As, bs, cs, whole=False, **kw) -> DeviceSolveResult:
    """One untiled batch: the two-phase driver for engine "sprint2"
    (with `whole`, phase 2 in one run, never compacted), else
    `device_solve_lp`."""
    if kw.get("engine") == "sprint2":
        return _solve_lp_batch_twophase(As, bs, cs, whole=whole, **kw)
    kw.pop("endgame", None)   # sprint2-only knob
    return _device_solve(As, bs, cs, **kw)


def _bucket(size):
    """Next power of two >= size (floor 4): the compacted rounds' batch
    sizes (`batched.py:929-936`)."""
    b = 4
    while b < size:
        b *= 2
    return b


def _resume_state(r: DeviceSolveResult):
    return (r.u_raw, r.v_raw, r.mu, r.admm_iters, r.ipm_iters, r.status,
            r.u_sum_raw, r.v_sum_raw, r.sj)


def _solve_lp_batch_twophase(As, bs, cs, whole=False,
                             **kw) -> DeviceSolveResult:
    """sprint2 (`batched.py:939-1059`): phase 1 drives every lane with
    the sprint engine (K6 chunks) until its barrier passes
    `sprint_mu_switch` (default 1e-4); phase 2 continues the unfinished
    lanes with `endgame` "steps" (default) or "delta", from the 9-tuple
    resume state.  Up to B=32, or with `whole` (a rank's share of a
    mesh), phase 2 is one whole-batch run; above, it runs in rounds of
    at most `compact_period` ADMM iterations, the unfinished lanes
    compacted into the next power-of-two bucket between rounds."""
    dev = As.device
    kw.pop("engine")
    switch = kw.pop("sprint_mu_switch", 1e-4)
    kw.pop("mu_stop", None)
    kw.pop("init_state", None)
    endgame = kw.pop("endgame", "steps")
    if endgame not in ("steps", "delta"):
        raise ValueError(f"endgame must be 'steps' or 'delta'; "
                         f"got {endgame!r}")
    compact_period = kw.pop("compact_period", 16384)
    kw1 = dict(kw, engine="sprint", sprint_mu_switch=switch, mu_stop=switch,
               precision=kw.get("precision", "mixed"))
    r1 = solve_lp_batch(As, bs, cs, device=dev, tile=0 if whole else 16,
                        **kw1)
    done1 = r1.status != 0
    if not _any(~done1):           # every lane finished in phase 1
        return r1
    kw2 = dict(kw, engine="delta" if endgame == "delta" else "steps")
    max_admm = kw.get("max_admm", 200_000)
    if whole or As.shape[0] <= 32:
        r2 = _device_solve(As, bs, cs, init_state=_resume_state(r1),
                           k_cap=max_admm, **kw2)
        return _select(done1, r1, r2)

    max_ipm = kw.get("max_ipm", 200)
    out = [f.clone() for f in r1]
    state = [t.clone() for t in _resume_state(r1)]
    _K, _I = 3, 4                                 # admm / ipm slots
    with host_read():
        active = np.flatnonzero(~done1.cpu().numpy())
    while active.size:
        nb = _bucket(active.size)
        # the bucket is padded with copies of active lanes
        idx = torch.as_tensor(active[np.arange(nb) % active.size],
                              device=dev)
        act = torch.as_tensor(active, device=dev)
        with host_read():
            prev_k = state[_K][act].cpu().numpy()
            prev_i = state[_I][act].cpu().numpy()
        # one shared cap: every active lane runs to the same rung
        caps = min(int(prev_k.max()) + compact_period, max_admm)
        r2 = _device_solve(As[idx], bs[idx], cs[idx],
                           init_state=tuple(s[idx] for s in state),
                           k_cap=caps, **kw2)
        live = slice(0, active.size)               # non-duplicate rows
        with host_read():
            k2 = r2.admm_iters[live].cpu().numpy()
            i2 = r2.ipm_iters[live].cpu().numpy()
            st2 = r2.status[live].cpu().numpy()
        # finished: converged, at the ADMM or IPM cap, or no progress
        fin = ((st2 != 0) | (k2 >= max_admm)
               | (i2 >= max_ipm) | ((k2 <= prev_k) & (i2 <= prev_i)))
        fin_t = torch.as_tensor(fin, device=dev)
        for f_out, f_new in zip(out, r2):
            f_out[act[fin_t]] = f_new[live][fin_t]
        for s_arr, f_new in zip(state, _resume_state(r2)):
            s_arr[act[~fin_t]] = f_new[live][~fin_t]
        active = active[~fin]
    return DeviceSolveResult(*out)


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
    `device` (default: the CUDA card), over `mesh` where given (see
    `solve_lp_batch`).

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
