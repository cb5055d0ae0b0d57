"""HSD/ADMM step math of the LP solvers, batched over lanes.

Port of `abip_tpu/hsd.py`.  The batched solvers give every function a
leading lane axis: an iterate `u` or `v` is a `(B, m + n + 1)` tensor, a
per-lane scalar is a `(B,)` tensor, and a matrix-vector product is a
callable from `(B, k)` to `(B, r)`.  The host LP driver gives the same
functions one instance: `(m + n + 1,)` iterates and 0-d scalars.
Comparisons with NaN are False, as in the reference
(`abip.c:1613-1641`), so a NaN certificate never fires.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

EPS_TOL = 1e-18
_TINY = 1e-300


def _lane(x, like):
    """A per-lane `(B,)` tensor as a `(B, 1)` column against `(B, k)`
    data; floats and already-broadcastable tensors pass through."""
    if isinstance(x, torch.Tensor) and x.dim() == 1 and like.dim() == 2:
        return x[..., None]
    return x


def safediv_pos(x, y):
    """SAFEDIV_POS from `glbopts.h:157-158`."""
    return torch.where(y < EPS_TOL, x / EPS_TOL, x / y)


def barrier_prox(t, lam):
    """Log-barrier prox: positive root of u^2 - t*u - lam = 0
    (`abip.c:717-748`), with the cancellation-free negative branch
    (`cones.c:279-289`).  `lam` is a float or a per-lane tensor."""
    lam = _lane(lam, t)
    pos = 0.5 * (t + torch.sqrt(t * t + 4.0 * lam))
    neg = 2.0 * lam / (-t * (1.0 + torch.sqrt(1.0 + 4.0 * lam / (t * t + _TINY)))
                       + _TINY)
    return torch.where(t >= 0, pos, neg)


def project_lin_sys(u, v, h, g, g_th, rho_y, solve_fn, k, m, n):
    """u_t = (I+Q)^-1 (u+v) via the cached KKT solve + rank-1 tau
    correction (`abip.c:539-562`).  `solve_fn(w_y, w_x, k, warm)` solves
    [[rho_y I, A],[A', -I]] z = w and returns (z_y, z_x, aux_iters);
    `g_th` is a tensor.  Returns (u_t, aux_iters)."""
    l = m + n + 1
    r = u + v
    q = torch.cat([rho_y * r[..., :m], r[..., m:m + n]], dim=-1)
    r_tau = r[..., l - 1:l]
    q = q - r_tau * h
    q = q - ((q * g).sum(-1, keepdim=True) / (g_th + 1.0)[..., None]) * h
    z_y, z_x, its = solve_fn(q[..., :m], -q[..., m:], k, u[..., :m])
    z = torch.cat([z_y, z_x], dim=-1)
    tau_t = r_tau + (z * h).sum(-1, keepdim=True)
    return torch.cat([z, tau_t], dim=-1), its


def admm_update(u, v, u_prev, u_t, lam, alpha, m):
    """project_barrier (`abip.c:717-748`) + update_dual_vars (`:567-584`)."""
    head = u_t[..., :m] - v[..., :m]
    rel = alpha * u_t[..., m:] + (1 - alpha) * u_prev[..., m:]
    tail = barrier_prox(rel - v[..., m:], lam)
    u_new = torch.cat([head, tail], dim=-1)
    v_new = torch.cat([v[..., :m], v[..., m:] + (
        tail - alpha * u_t[..., m:] - (1 - alpha) * u_prev[..., m:])], dim=-1)
    return u_new, v_new


def admm_update_half(u, v, u_t, lam, m):
    """half_update variant (`abip.c:663-711`)."""
    v_half = v + 0.5 * (u - u_t)
    w = u_t - v_half
    tail = barrier_prox(w[..., m:], lam)
    u_new = torch.cat([w[..., :m], tail], dim=-1)
    v_new = v_half + (u_new - u_t)
    return u_new, v_new


def q_norm_resd(u, v, matvec, rmatvec, b, c, m, n):
    """HSD-operator residual of one iterate (`abip.c:1951-1996`)."""
    l = m + n + 1
    y, x, tau = u[..., :m], u[..., m:m + n], u[..., l - 1:l]
    s, kap = v[..., m:m + n], v[..., l - 1]
    q1 = matvec(x) - b * tau
    q2 = rmatvec(y) + s - c * tau
    q3 = (y * b).sum(-1) - (x * c).sum(-1) - kap
    qres = (q1 * q1).sum(-1) + (q2 * q2).sum(-1) + q3 * q3
    norm = 1.0 + torch.sqrt((u * u).sum(-1) + (v * v).sum(-1))
    return torch.sqrt(qres) / norm


class LPResiduals(NamedTuple):
    res_pri: torch.Tensor
    res_dual: torch.Tensor
    rel_gap: torch.Tensor
    res_infeas: torch.Tensor
    res_unbdd: torch.Tensor
    tau: torch.Tensor
    kap: torch.Tensor
    bt_y_by_tau: torch.Tensor
    ct_x_by_tau: torch.Tensor

    @staticmethod
    def init(B, dtype=torch.float64, device=None):
        """B lanes, or one instance's 0-d fields for B=()."""
        shape = (B,) if isinstance(B, int) else tuple(B)
        z = torch.zeros(shape, dtype=dtype, device=device)
        nan = torch.full(shape, float("nan"), dtype=dtype, device=device)
        return LPResiduals(nan, nan, nan, nan, nan, z, z, z, z)


def lp_residuals(u, v, matvec, rmatvec, b, c, pr_scale, dr_scale, obj_scale,
                 nm_b, nm_c, m, n) -> LPResiduals:
    """`calc_residuals` (`abip.c:458-535`) on a chosen iterate, in original
    (unscaled) units via the pr/dr scale vectors.  `obj_scale`, `nm_b`
    and `nm_c` are per-lane `(B,)` tensors."""
    l = m + n + 1
    y, x, tau_raw = u[..., :m], u[..., m:m + n], u[..., l - 1]
    s = v[..., m:m + n]
    tau = tau_raw.abs()
    kap = v[..., l - 1].abs() / obj_scale

    pr = matvec(x)
    nm_A_x = torch.linalg.vector_norm(pr * pr_scale, dim=-1)
    pres = torch.linalg.vector_norm((pr - b * tau[..., None]) * pr_scale,
                                    dim=-1)

    dr = rmatvec(y) + s
    nm_At_ys = torch.linalg.vector_norm(dr * dr_scale, dim=-1)
    dres = torch.linalg.vector_norm((dr - c * tau[..., None]) * dr_scale,
                                    dim=-1)

    bty = (y * b).sum(-1) / obj_scale
    ctx = (x * c).sum(-1) / obj_scale
    nan = torch.full_like(bty, float("nan"))
    one = torch.ones_like(bty)
    res_infeas = torch.where(
        bty > 0, nm_b * nm_At_ys / torch.where(bty > 0, bty, one), nan)
    res_unbdd = torch.where(
        ctx < 0, nm_c * nm_A_x / torch.where(ctx < 0, -ctx, one), nan)

    bt_y = safediv_pos(bty, tau)
    ct_x = safediv_pos(ctx, tau)
    return LPResiduals(
        res_pri=safediv_pos(pres / (1 + nm_b), tau),
        res_dual=safediv_pos(dres / (1 + nm_c), tau),
        rel_gap=(ct_x - bt_y).abs() / (1 + ct_x.abs() + bt_y.abs()),
        res_infeas=res_infeas,
        res_unbdd=res_unbdd,
        tau=tau,
        kap=kap,
        bt_y_by_tau=bty,
        ct_x_by_tau=ctx,
    )


def lp_converged_code(r: LPResiduals, eps, pfeasopt, total_pos):
    """`has_converged` (`abip.c:1613-1641`) as an int32 status code per
    lane.  NaN certificate residuals compare False."""
    solved = (r.res_pri < eps) & ((r.res_dual < eps) | pfeasopt) \
        & (r.rel_gap < eps)
    unbdd = (r.res_unbdd < eps) & total_pos
    infeas = (r.res_infeas < eps) & total_pos
    code = torch.zeros(r.res_pri.shape, dtype=torch.int32,
                       device=r.res_pri.device)
    code = torch.where(infeas, -2, code)
    code = torch.where(unbdd, -1, code)
    return torch.where(solved, 1, code).to(torch.int32)


def reinit_rebalance(u, v, sigma, m):
    """`reinitialize_vars(w, 0)` (`abip.c:996-1075`): shrink the larger of
    (u_i, v_i) by sigma on the barrier coordinates."""
    ut, vt = u[..., m:], v[..., m:]
    cond = ut > vt
    v_new = torch.cat([v[..., :m], torch.where(cond, sigma * vt, vt)], dim=-1)
    u_new = torch.cat([u[..., :m], torch.where(cond, ut, sigma * ut)], dim=-1)
    return u_new, v_new


def mu_update_hybrid(mu, u, v, m, eps, hybrid_thresh, dynamic_x, dynamic_eta,
                     shrink_second):
    """Hybrid mu rule (`abip.c:2251-2277` with defaults hybrid_mu=1,
    dynamic_sigma=-1, dynamic_sigma_second=0.5): aggressive
    `mu *= min(x*mu, mu^eta)` until mu < hybrid_thresh*eps, then the
    LOQO rule.  `mu` is `(B,)`."""
    # aggressive (`abip.c:982-992`)
    mu_aggr = mu * torch.minimum(dynamic_x * mu, mu ** dynamic_eta)
    # LOQO (`abip.c:930-977`)
    xs = u[..., m:] * v[..., m:]
    minxs = xs.amin(-1)
    mean = xs.mean(-1)
    ksi = minxs / mean.clamp_min(EPS_TOL)
    sigma = torch.clamp(0.05 * (1 - ksi) / ksi.clamp_min(1e-16), max=2.0)
    sigma = torch.clamp(0.1 * sigma ** 3, min=shrink_second)
    sigma = torch.where(minxs <= 0,
                        torch.full_like(sigma, max(shrink_second, 0.1)),
                        sigma)
    mu_loqo = mu * sigma
    return torch.where(mu < hybrid_thresh * eps, mu_loqo, mu_aggr)
