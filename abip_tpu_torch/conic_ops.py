"""Conic residuals, stopping codes and the barrier schedule, batched.

Port of `abip_tpu/conic_ops.py:20-216` (the parts the sprint2 path
runs): the inner HSD-operator criterion, the unscaled residuals with
the infeasibility/unboundedness certificates, `has_converged` and the
device `adjust_barrier`.  Every function takes `(B, ...)` tensors, lane
axis first, and returns `(B,)` tensors; `matvec`/`rmatvec`/`Q_times`
apply each lane's operator to a `(B, k)` stack.  The DR step math of the
steps engine (`projection`, `barrier_and_dual`) is not ported yet
(ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

EPS_TOL = 1e-18


def _dot(a, b):
    return (a * b).sum(-1)


def _amax(x):
    return torch.abs(x).amax(-1)


class ConicResiduals(NamedTuple):
    res_pri: torch.Tensor
    res_dual: torch.Tensor
    rel_gap: torch.Tensor
    res_dif: torch.Tensor
    error_ratio: torch.Tensor
    res_infeas: torch.Tensor
    res_unbdd: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    tau: torch.Tensor
    kap: torch.Tensor
    Ax_b_norm: torch.Tensor
    Qx_ATy_c_s_norm: torch.Tensor

    @staticmethod
    def init(B, dtype=torch.float64, device=None):
        big = torch.full((B,), 1e8, dtype=dtype, device=device)
        one = torch.ones((B,), dtype=dtype, device=device)
        nan = torch.full((B,), float("nan"), dtype=dtype, device=device)
        return ConicResiduals(big, big, big, big, big, nan, nan, nan, nan,
                              one, one, big, big)


def inner_conv_check(u, v_origin, matvec, rmatvec, Q_times, b, c, m, n):
    """HSD-operator mismatch (`qcp_inner_conv_check`,
    `qcp_config.c:518-557`)."""
    l = m + n + 1
    y, x, tau = u[:, :m], u[:, m:m + n], u[:, l - 1]
    Mu_y = matvec(x)
    Mu_x = -rmatvec(y) + Q_times(x)
    Qu_y = Mu_y - b * tau[:, None]
    Qu_x = Mu_x + c * tau[:, None]
    Mu = torch.cat([Mu_y, Mu_x], dim=1)
    tau_safe = torch.where(torch.abs(tau) < EPS_TOL,
                           torch.full_like(tau, EPS_TOL), tau)
    Qu_tau = -_dot(u[:, :m + n], Mu) / tau_safe + _dot(y, b) - _dot(x, c)
    Qu = torch.cat([Qu_y, Qu_x, Qu_tau[:, None]], dim=1)
    diff = Qu - v_origin
    return torch.linalg.vector_norm(diff, dim=-1) / (
        1.0 + torch.linalg.vector_norm(Qu, dim=-1)
        + torch.linalg.vector_norm(v_origin, dim=-1))


def conic_residuals(u, v_origin, prev: ConicResiduals, matvec, rmatvec,
                    Q_times, b, c, D, E, sc_b, sc_c, scale, nm_inf_b,
                    nm_inf_c, eps_p, eps_d, eps_g, m, n):
    """`calc_qcp_residuals` (`qcp_config.c:562-691`): unscaled inf-norm
    residuals + infeasibility/unboundedness certificates.  sc_b, sc_c,
    nm_inf_b, nm_inf_c are `(B,)`."""
    l = m + n + 1
    tau = torch.abs(u[:, l - 1])
    tau_safe = torch.clamp(tau, min=EPS_TOL)[:, None]
    kap = torch.abs(v_origin[:, l - 1]) / (scale * sc_c * sc_b)
    y = u[:, :m] / tau_safe
    x = u[:, m:m + n] / tau_safe
    s = v_origin[:, m:m + n] / tau_safe

    Ax = matvec(x)
    Ax_b = Ax - b
    Ax_b_norm = _amax(Ax_b)
    DAx = D * Ax
    DAx_b = D * Ax_b
    res_pri = _amax(DAx_b) / (
        sc_b + torch.maximum(_amax(DAx), sc_b * nm_inf_b))

    Qx = Q_times(x)
    xQx_2 = _dot(x, Qx) / (2.0 * sc_b * sc_c)
    ATy = rmatvec(y)
    dres_vec = Qx - ATy + c - s
    Qx_ATy_c_s_norm = _amax(dres_vec)
    res_dual = _amax(E * dres_vec) / (
        sc_c + torch.maximum(sc_c * nm_inf_c, _amax(E * Qx)))

    cTx = _dot(c, x) / (sc_b * sc_c)
    bTy = _dot(b, y) / (sc_b * sc_c)
    rel_gap = torch.abs(2.0 * xQx_2 + cTx - bTy) / (
        1.0 + torch.maximum(2.0 * xQx_2,
                            torch.maximum(torch.abs(cTx), torch.abs(bTy))))
    pobj = xQx_2 + cTx
    dobj = -xQx_2 + bTy

    res_dif = torch.maximum(
        torch.maximum(torch.abs(res_pri - prev.res_pri),
                      torch.abs(res_dual - prev.res_dual)),
        torch.abs(rel_gap - prev.rel_gap))
    error_ratio = torch.maximum(
        res_pri / eps_p, torch.maximum(res_dual / eps_d, rel_gap / eps_g))

    ctx_u = _dot(c, u[:, m:m + n])
    nan = torch.full_like(ctx_u, float("nan"))
    tau_c = tau[:, None]
    unb_num = torch.maximum(torch.linalg.vector_norm(E * Qx * tau_c, dim=-1),
                            torch.linalg.vector_norm(DAx * tau_c, dim=-1))
    res_unbdd = torch.where(
        ctx_u < 0, unb_num / torch.where(ctx_u < 0, -ctx_u,
                                         torch.ones_like(ctx_u)), nan)
    bty_u = _dot(b, u[:, :m])
    inf_num = torch.linalg.vector_norm(E * (ATy * tau_c + s * tau_c), dim=-1)
    res_infeas = torch.where(
        bty_u > 0, inf_num / torch.where(bty_u > 0, bty_u,
                                         torch.ones_like(bty_u)), nan)

    return ConicResiduals(
        res_pri=res_pri, res_dual=res_dual, rel_gap=rel_gap,
        res_dif=res_dif, error_ratio=error_ratio,
        res_infeas=res_infeas, res_unbdd=res_unbdd,
        pobj=pobj, dobj=dobj, tau=tau, kap=kap,
        Ax_b_norm=Ax_b_norm, Qx_ATy_c_s_norm=Qx_ATy_c_s_norm)


def conic_converged_code(r: ConicResiduals, eps_p, eps_d, eps_g, eps_inf,
                         eps_unb, err_dif, total_pos):
    """`has_converged` (`source/abip.c:750-777`); int32 `(B,)`."""
    solved = (r.res_pri < eps_p) & (r.res_dual < eps_d) & (r.rel_gap < eps_g)
    stag = r.res_dif < err_dif * max(eps_p, eps_d, eps_g)
    unbdd = (r.res_unbdd < eps_unb) & total_pos
    infeas = (r.res_infeas < eps_inf) & total_pos
    code = torch.where(infeas, -2, 0)
    code = torch.where(unbdd, -1, code)
    code = torch.where(stag, 2, code)
    return torch.where(solved, 1, code).to(torch.int32)


# gamma by mu/eps ratio buckets; NOTE the reference quirk: a ratio above
# 100 falls through to the final else and gets 0.5
# (`source/abip.c:1002-1030`) -- replicated
_RATIO_EDGES = (5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 0.5, 1.0,
                5.0, 10.0, 50.0, 100.0)
_RATIO_VALS = (0.5, 0.6, 0.6, 0.7, 0.7, 0.8, 0.8, 0.9, 0.9, 1.0, 1.1, 1.2,
               1.3, 1.5, 0.5)
_ERR_EDGES = (1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 15.0, 18.0, 22.0)
_GMUL_VALS = (2.4, 2.6, 2.8, 3.2, 3.4, 3.4, 3.6, 3.8, 4.0, 4.2, 4.4)
_SIG_VALS = (0.85, 0.85, 0.85, 0.83, 0.82, 0.81, 0.8, 0.8, 0.8, 0.8, 0.8)


def _lookup(edges, vals, x):
    """`vals[searchsorted(edges, x, side="right")]` for a `(B,)` tensor."""
    e = torch.tensor(edges, dtype=x.dtype, device=x.device)
    v = torch.tensor(vals, dtype=x.dtype, device=x.device)
    return v[torch.searchsorted(e, x.contiguous(), right=True)]


def adjust_barrier_device(mu, error_ratio, eps_min, psi):
    """Device version of `adjust_barrier` (`source/abip.c:994-1071`):
    the sigma/gamma bucket tables as searchsorted lookups.  Returns
    (mu_new, tol_inner)."""
    gamma = _lookup(_RATIO_EDGES, _RATIO_VALS, mu / eps_min)
    gamma = gamma * _lookup(_ERR_EDGES, _GMUL_VALS, error_ratio)
    sigma = _lookup(_ERR_EDGES, _SIG_VALS, error_ratio) * 0.2
    mu_new = sigma * mu
    return mu_new, gamma * mu_new ** psi
