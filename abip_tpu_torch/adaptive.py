"""Adaptive penalty (beta) via the Barzilai-Borwein spectral method.

Port of `abip_tpu/adaptive.py` (the reference's `adaptive.c:34-256`):
between barrier stages, run up to `adaptive_lookback` trial rounds of two
ADMM steps each (the trial iterates are discarded), estimate the spectral
stepsizes

    alpha_SD = <dv,dv>/<dut,dv>,   alpha_MG = <dut,dv>/<dut,dut>
    gamma_SD = <dv,dv>/<du,dv>,    gamma_MG = <du,dv>/<du,du>

pick the safeguarded stepsize (MG if 2*MG > SD else SD - MG/2), gate by
the correlations against `eps_cor`, and fix the penalty at
beta = sqrt(alpha_ss * gamma_ss) (or the surviving one).  The search
stops early when 0 < |beta - beta_prev| <= eps_pen (`adaptive.c:225-229`).

The reference's `lax.while_loop` is a host loop: the scalar algebra stays
on the device in the iterate's dtype, and the early stop is read back
once per trial.
"""
from __future__ import annotations

import torch

from . import hsd
from .utils.profiling import host_read

_TINY = 1e-300


def bb_update_beta(u, v, mu, h, g, g_th, rho_y, alpha, solve_fn, m, n,
                   lookback, eps_cor, eps_pen):
    """Return the new penalty beta (`update_adapt_params`) as a 0-d
    tensor."""
    dtype, dev = u.dtype, u.device
    mu = torch.as_tensor(mu, dtype=dtype, device=dev)

    def admm_trial(u_in, v_in, beta_prev):
        u_t, _ = hsd.project_lin_sys(u_in, v_in, h, g, g_th, rho_y,
                                     solve_fn, 0, m, n)
        return hsd.admm_update(u_in, v_in, u_in, u_t, mu / beta_prev, alpha,
                               m)

    def dot(a, b):
        return (a * b).sum()

    u_prev, v_prev = u, v
    beta_prev = torch.ones((), dtype=dtype, device=dev)
    beta = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(lookback):
        u1, v1 = admm_trial(u_prev, v_prev, beta_prev)
        u2, v2 = admm_trial(u1, v1, beta_prev)

        # spectral deltas (`adaptive.c:154-168`)
        d_ut = 2.0 * v1 + u2 - u1 - v2 - v_prev
        d_u = u1 - u2
        d_v = (alpha - 1.0) * (u2 - u1) + v2 - v1

        utut, utv = dot(d_ut, d_ut), dot(d_ut, d_v)
        uu, vv, uv = dot(d_u, d_u), dot(d_v, d_v), dot(d_u, d_v)
        nm_ut, nm_u, nm_v = torch.sqrt(utut), torch.sqrt(uu), torch.sqrt(vv)

        alpha_SD = vv / (utv + _TINY)
        alpha_MG = utv / (utut + _TINY)
        gamma_SD = vv / (uv + _TINY)
        gamma_MG = uv / (uu + _TINY)
        alpha_ss = torch.where(2 * alpha_MG > alpha_SD, alpha_MG,
                               alpha_SD - 0.5 * alpha_MG)
        gamma_ss = torch.where(2 * gamma_MG > gamma_SD, gamma_MG,
                               gamma_SD - 0.5 * gamma_MG)
        ok_a = utv / (nm_v * nm_ut + _TINY) > eps_cor
        ok_g = uv / (nm_v * nm_u + _TINY) > eps_cor
        beta_new = torch.where(
            ok_a & ok_g, torch.sqrt(torch.abs(alpha_ss * gamma_ss)),
            torch.where(ok_a, alpha_ss, torch.where(ok_g, gamma_ss,
                                                    beta_prev)))

        diff = torch.abs(beta_new - beta_prev)
        converged = (diff > 0) & (diff <= eps_pen)
        beta = torch.where(converged, 0.5 * (beta_new + beta_prev), beta_new)

        # continue searching: re-center the trial point (`adaptive.c:230-247`)
        moved = diff > eps_pen
        beta_prev = torch.where(moved, beta_new, beta_prev)
        v_tail = (mu / beta_prev) / torch.clamp(u1[m:], min=_TINY)
        v_prev = torch.where(moved, torch.cat([v1[:m], v_tail]), v1)
        u_prev = u1
        with host_read():
            stop = bool(converged)
        if stop:
            break
    # guard degenerate outcomes: keep beta positive and finite
    bad = ~torch.isfinite(beta) | (beta <= 0)
    return torch.where(bad, torch.ones_like(beta), beta)
