"""Barrier (mu) schedules and host-side convergence classification.

Copy of `abip_tpu/schedules.py` (it uses no JAX): the reference's three mu
strategies and their hybrid dispatch (`src/abip-lp/src/abip.c:753-992,
2251-2277`).  These run on the host between barrier stages, on host
floats, so plain Python branching is the right tool.
"""
from __future__ import annotations

import math

from .settings import Settings, Status


def check_converged(res: dict, stgs: Settings, ipm_iter: int, admm_iter: int) -> int:
    """`has_converged` (`abip.c:1613-1641`) on host floats.

    NaN certificate residuals compare False, as in C.
    """
    eps = stgs.eps
    if (
        res["res_pri"] < eps
        and (res["res_dual"] < eps or stgs.pfeasopt)
        and res["rel_gap"] < eps
    ):
        return Status.SOLVED
    if res["res_unbdd"] < eps and ipm_iter > 0 and admm_iter > 0:
        return Status.UNBOUNDED
    if res["res_infeas"] < eps and ipm_iter > 0 and admm_iter > 0:
        return Status.INFEASIBLE
    return Status.UNFINISHED


def _gamma_table(ratio: float, dense: bool) -> float:
    """mu/eps ratio -> gamma (`abip.c:764-801` dense, `:833-868` sparse)."""
    if ratio > 10.0:
        return 2.0 if dense else 3.0
    if ratio > 1.0:
        return 1.0
    if ratio > 0.5:
        return 0.9
    if ratio > 0.1:
        return 0.8
    if ratio > 0.05:
        return 0.7
    if ratio > 0.01:
        return 0.6
    if ratio > 0.005:
        return 0.5
    if ratio > 0.001:
        return 0.4
    return 0.3


def update_mu_tedious(mu, sigma, gamma, res, stgs: Settings, sp,
                      final_check, double_check):
    """The tabulated sigma/gamma schedule (`abip.c:753-921`)."""
    ratio = mu / stgs.eps
    err_ratio = max(res["res_pri"], res["res_dual"], res["rel_gap"]) / stgs.eps

    sp_hi = max(sp, stgs.sparsity_ratio)
    sp_lo = min(sp, stgs.sparsity_ratio)
    dense = sp_hi > 0.4 or sp_lo > 0.1

    g = _gamma_table(ratio, dense)

    if dense:
        if 6 < err_ratio <= 10:
            sigma = 0.5
        elif 3 < err_ratio <= 6:
            sigma = 0.6
            g *= 0.8
        elif 1 < err_ratio <= 3:
            final_check = True
            g *= 0.4
            sigma = 0.8 if ratio < 0.1 else 0.7
        # else: keep previous sigma
    else:
        if 6 < err_ratio <= 10:
            sigma = 0.82
            g *= 0.8
        elif 4 < err_ratio <= 6:
            sigma = 0.84
            g *= 0.6
        elif 3 < err_ratio <= 4:
            sigma = 0.85
            g *= 0.5
            final_check = True
        elif 1 < err_ratio <= 3:
            final_check = True
            if ratio < 0.1:
                if double_check:
                    sigma = 0.9
                    g *= 0.4
                    double_check = False
                else:
                    sigma = 1.0
                    g *= 0.1
                    double_check = True
            else:
                sigma = 0.88
                g *= 0.4

    mu = mu * sigma
    return mu, sigma, g, final_check, double_check


def update_mu_loqo(mu, u, v, m, shrink):
    """LOQO-style rule (`abip.c:930-977`):
       ksi = min(x_i s_i) / mean(x s); sigma = max(0.1*min(.05(1-ksi)/ksi,2)^3, shrink)."""
    xs = u[m:] * v[m:]
    minxs = float(xs.min())
    mean = float(xs.mean())
    if minxs <= 0.0 or mean <= 0.0:
        # The reference asserts here (`abip.c:967-970`); we degrade gracefully.
        return mu * max(shrink, 0.1)
    ksi = minxs / mean
    sigma = min(0.05 * (1 - ksi) / max(ksi, 1e-16), 2.0)
    sigma = max(0.1 * sigma ** 3, shrink)
    return mu * sigma


def update_mu_aggressive(mu, stgs: Settings, dynamic_sigma):
    """Aggressive rule (`abip.c:982-992`): mu *= min(x*mu, mu^eta).

    The reference reads the exponent from the *current* ``dynamic_sigma``
    (`abip.c:989`: ``eta = stgs->dynamic_sigma``), not from the parsed-but-
    unused ``dynamic_eta`` setting -- match that, since hybrid dispatch
    mutates dynamic_sigma mid-solve.
    """
    return mu * min(stgs.dynamic_x * mu, math.pow(mu, dynamic_sigma))


def update_mu(mu, sigma, gamma, res, stgs: Settings, sp,
              final_check, double_check, dynamic_sigma,
              u=None, v=None, m=None):
    """Hybrid dispatch (`abip.c:2251-2277`).

    Returns (mu, sigma, gamma, final_check, double_check, dynamic_sigma).
    `u, v, m` are only needed when the LOQO rule can fire.
    """
    if stgs.hybrid_mu:
        if stgs.dynamic_sigma_second > 0.0 and mu < stgs.hybrid_thresh * stgs.eps:
            dynamic_sigma = stgs.dynamic_sigma_second
            mu = update_mu_loqo(mu, u, v, m, dynamic_sigma)
        elif stgs.dynamic_sigma_second == 0.0 and mu < stgs.hybrid_thresh * stgs.eps:
            dynamic_sigma = stgs.dynamic_sigma_second
            mu, sigma, gamma, final_check, double_check = update_mu_tedious(
                mu, sigma, gamma, res, stgs, sp, final_check, double_check
            )
        elif dynamic_sigma < 0.0:
            mu = update_mu_aggressive(mu, stgs, dynamic_sigma)
    else:
        if dynamic_sigma == 0.0:
            mu, sigma, gamma, final_check, double_check = update_mu_tedious(
                mu, sigma, gamma, res, stgs, sp, final_check, double_check
            )
        elif dynamic_sigma < 0.0:
            mu = update_mu_aggressive(mu, stgs, dynamic_sigma)
        else:
            mu = update_mu_loqo(mu, u, v, m, dynamic_sigma)
    return mu, sigma, gamma, final_check, double_check, dynamic_sigma
