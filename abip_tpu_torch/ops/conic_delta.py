"""Anchored-delta conic DR endgame: f64-quality iterates from f32 iterations.

Port of `abip_tpu/ops/conic_delta.py:61-688`; derivation in
`docs/conic_delta_design.md`.  A chunk iterates DELTAS from an f64 anchor
entirely in f32:

* The anchor is the exact f64 entry state; its images (one absolute DR
  iteration `F(anchor) - anchor`, the prox-argument anchors, the
  inner-criterion anchors) are computed once per chunk in f64 by
  `conic_delta_anchor`.
* Every f32 quantity is a delta, so f32's relative error becomes a tiny
  absolute error.
* Nonlinear maps are differenced algebraically, one intermediate at a
  time, with the O(1) parts factored out; the cone prox delta
  P(dt) = prox(t0 + dt) - prox(t0) is 0 at dt = 0 by construction, so
  the per-block anchor chains can be recomputed in f32 from the stored
  f32 `t0x` row.
* Branch seams (sign(a), |a| <= tol, RSOC d <> 0, degenerate blocks):
  where anchor and current point take different branches, the delta
  falls back to the direct difference of the recomputed chain values.
  The RSOC chain marks a mismatch with NaN and then replaces EVERY NaN
  delta, sentinel or genuine, with the direct difference.

`_conic_delta_compute` is the plain PyTorch version of the chunk;
`csrc/conic_delta.cu` is the CUDA kernel; `run_conic_delta_chunk` takes
the plain version on CPU tensors and the kernel on CUDA tensors, or
raises.  Layout as in `ops/conic_dr.py`: lane axis first, no padding.

Reference math: SOC/RSOC barrier prox `cones.c:130-248`, orthant
`cones.c:279-289`, inner criterion `qcp_config.c:518-557`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cones import (E_RSOC_H1, E_RSOC_H2, E_SOC_H, Blocks, ConeOperands,
                     cone_barrier_prox)
from .admm_delta import _mv, _per_lane, _rmv
from .conic_dr import (_bsum, _cone_kernel_inputs, _elementwise_prox, _full,
                       _need_ieee, _unpad, check_operands, launch, solve_S)

f32 = torch.float32
f64 = torch.float64
_TINY = 1e-30
_SOC_TOL = 1e-6
_EPS_TAU = 1e-18
_NAN = float("nan")


# ---------------------------------------------------------------------------
# absolute chains (f32): the anchor recomputation and the branch-mismatch
# fallbacks; exactly the formulas of `ops/conic_dr.py`
# ---------------------------------------------------------------------------

def _soc_chain(a, bsq, lam):
    """(a, bsq) -> (x0_zero, denom, R, D, r, disc, s, s_safe, eta, sc,
    small)."""
    x0_zero = torch.sqrt(2.0 * lam + bsq / 4.0)
    denom = 8.0 * lam - a * a + bsq
    R = torch.sqrt(denom * denom + 32.0 * a * a * lam)
    D = denom + R + _TINY
    r = 16.0 * a * a / D
    disc = torch.sqrt(torch.clamp(r * (r + 8.0), min=0.0))
    s = torch.where(a > 0, (r + disc) / 2.0, (r - disc) / 2.0)
    s_safe = torch.where(torch.abs(s) < _TINY, _TINY, s)
    eta = (s + 2.0) * a / s_safe
    sc = (s + 2.0) / (s + 4.0)
    small = torch.abs(a) <= _SOC_TOL
    eta = torch.where(small, x0_zero, eta)
    sc = torch.where(small, 0.5, sc)
    return x0_zero, denom, R, D, r, disc, s, s_safe, eta, sc, small


def _rsoc_chain(ze, zn, zxsq, lam):
    """(ze, zn, zxsq) -> (x1, x2, sc) + the branch masks."""
    sum_zz = ze + zn
    d = 2.0 * ze * zn - zxsq
    g = d / (2.0 * lam)
    g_neg = torch.where(g < 0, -g, 1.0)
    g_pos = torch.where(g > 0, g, 1.0)
    q = 4.0 * (ze * ze + zn * zn + zxsq) / lam + 16.0
    w_neg = (2.0 * sum_zz * sum_zz / lam) / g_neg / (
        1.0 + 4.0 / g_neg + torch.sqrt(1.0 + q / (g_neg * g_neg)))
    w_pos = g_pos * (
        1.0 - 4.0 / g_pos + torch.sqrt(1.0 + q / (g_pos * g_pos))) / 2.0
    w = torch.where(d < 0, w_neg, w_pos)
    root = torch.sqrt(torch.clamp(w * (w + 4.0), min=0.0))
    s_a = (w + root) / 2.0
    s_b = 2.0 / (w + 2.0 + root + _TINY)
    s_c = (w - root) / 2.0

    def heads_std(s):
        den = s * (s + 2.0)
        den = torch.where(torch.abs(den) < _TINY, _TINY, den)
        x1 = (ze * (s + 1.0) ** 2 + zn * (s + 1.0)) / den
        x2 = (zn * (s + 1.0) ** 2 + ze * (s + 1.0)) / den
        return x1, x2, (s + 1.0) / (s + 2.0)

    def heads_b(s):
        den = (s - 1.0) * (s + 1.0)
        den = torch.where(torch.abs(den) < _TINY, _TINY, den)
        x1 = (ze * s * s + zn * s) / den
        x2 = (zn * s * s + ze * s) / den
        return x1, x2, s / (s + 1.0)

    xa1, xa2, sca = heads_std(s_a)
    xb1, xb2, scb = heads_b(s_b)
    xc1, xc2, scc = heads_std(s_c)
    pos_branch = sum_zz > 0
    b_branch = (~pos_branch) & (w > 10.0)
    x1 = torch.where(pos_branch, xa1, torch.where(b_branch, xb1, xc1))
    x2 = torch.where(pos_branch, xa2, torch.where(b_branch, xb2, xc2))
    sc = torch.where(pos_branch, sca, torch.where(b_branch, scb, scc))
    x2_deg = (-ze + torch.sqrt(ze * ze + 4.0 * lam + zxsq)) / 2.0
    deg = sum_zz == 0
    x1 = torch.where(deg, x2_deg + ze, x1)
    x2 = torch.where(deg, x2_deg, x2)
    sc = torch.where(deg, 0.5, sc)
    return x1, x2, sc, pos_branch, b_branch, deg


def _prox_nn_delta(dt, t0, lam):
    """Orthant barrier-prox delta (the LP `_prox_delta` with s0 computed
    in the chain)."""
    s0 = torch.sqrt(t0 * t0 + 4.0 * lam)
    t = t0 + dt
    s = torch.sqrt(t * t + 4.0 * lam)
    ds = dt * (t0 + t) / (s + s0)
    pos = 0.5 * (dt + ds)
    neg = 2.0 * lam * (dt - ds) / ((s - t) * (s0 - t0) + _TINY)
    return torch.where(t >= 0, pos, neg)


def _soc_delta(a0, bsq0, da, dbsq, lam, ch0=None):
    """Stable (d_eta, d_sc) for the SOC chain; the direct f32 chain
    difference on branch mismatches.  `ch0`: the anchor's chain, when
    the caller holds it."""
    (x0z0, den0, R0, D0, r0, disc0, s0, s0_safe, eta0, sc0,
     small0) = _soc_chain(a0, bsq0, lam) if ch0 is None else ch0
    a = a0 + da
    bsq = bsq0 + dbsq
    (x0z, den, R, D, r, disc, s, s_safe, eta_c, sc_c,
     small) = _soc_chain(a, bsq, lam)
    # telescoped identities (exact in exact arithmetic, same branch)
    dx0z = (dbsq / 4.0) / (x0z + x0z0 + _TINY)
    dden = -(a0 + a) * da + dbsq
    dR = ((den0 + den) * dden + 32.0 * lam * (a0 + a) * da) / (R + R0 + _TINY)
    dD = dden + dR
    dr = (16.0 * (a0 + a) * da - r0 * dD) / D
    ddisc = (r0 + r + 8.0) * dr / (disc + disc0 + _TINY)
    sgn = torch.where(a > 0, _full(a, 1.0), _full(a, -1.0))
    ds = (dr + sgn * ddisc) / 2.0
    # eta = a + 2a/s  ->  d = da + 2 (da s0 - a0 ds) / (s s0)
    d_eta = da + 2.0 * (da * s0_safe - a0 * ds) / (s_safe * s0_safe)
    d_sc = 2.0 * ds / ((s + 4.0) * (s0 + 4.0))
    # small-|a| branch: eta = x0_zero, sc = 1/2
    d_eta = torch.where(small0 & small, dx0z, d_eta)
    d_sc = torch.where(small0 & small, 0.0, d_sc)
    # branch mismatch (sign flip or small-flag flip): direct difference
    mismatch = (small0 != small) | ((a0 > 0) != (a > 0))
    d_eta = torch.where(mismatch, eta_c - eta0, d_eta)
    d_sc = torch.where(mismatch, sc_c - sc0, d_sc)
    return d_eta, d_sc


def _rsoc_delta(ze0, zn0, zx0, dze, dzn, dzx, lam, ch0=None):
    """Stable (d_x1, d_x2, d_sc) for the RSOC chain (`cones.c:169-248`):
    every intermediate's delta is an exact identity given the previous
    deltas; w_pos uses g (1 - 4/g + sqrt(1 + q/g^2)) =
    g - 4 + sqrt(g^2 + q) (g > 0).  Branch mismatches (d sign, b-form,
    degenerate) become NaN and then the direct difference, as does any
    other NaN delta.  `ch0`: the anchor's chain, when the caller holds
    it."""
    x1_0, x2_0, sc_0, pb0, bb0, dg0 = (_rsoc_chain(ze0, zn0, zx0, lam)
                                       if ch0 is None else ch0)
    ze, zn, zx = ze0 + dze, zn0 + dzn, zx0 + dzx
    x1_c, x2_c, sc_c, pbc, bbc, dgc = _rsoc_chain(ze, zn, zx, lam)

    sum0 = ze0 + zn0
    sumc = ze + zn
    dsum = dze + dzn
    d0 = 2.0 * ze0 * zn0 - zx0
    dc_ = 2.0 * zn0 * dze + 2.0 * ze * dzn - dzx   # exact telescope
    d_c = d0 + dc_
    dg = dc_ / (2.0 * lam)
    g0 = d0 / (2.0 * lam)
    gc = d_c / (2.0 * lam)
    q0 = 4.0 * (ze0 * ze0 + zn0 * zn0 + zx0) / lam + 16.0
    dq = 4.0 * ((ze0 + ze) * dze + (zn0 + zn) * dzn + dzx) / lam
    qc = q0 + dq

    # w, negative-d branch: w = (N u) / E with N = 2 sum^2/lam,
    # u = 1/g_neg, E = 1 + 4u + sqrt(1 + q u^2)
    gn0 = torch.where(g0 < 0, -g0, 1.0)
    gnc = torch.where(gc < 0, -gc, 1.0)
    dgn = torch.where((g0 < 0) & (gc < 0), -dg, gnc - gn0)
    u0 = 1.0 / gn0
    uc = 1.0 / gnc
    du = -dgn / (gn0 * gnc)
    N0 = 2.0 * sum0 * sum0 / lam
    dN = 2.0 * (sum0 + sumc) * dsum / lam
    h0 = torch.sqrt(1.0 + q0 * u0 * u0)
    hc = torch.sqrt(1.0 + qc * uc * uc)
    dh = (dq * uc * uc + q0 * (u0 + uc) * du) / (h0 + hc)
    E0 = 1.0 + 4.0 * u0 + h0
    Ec = 1.0 + 4.0 * uc + hc
    dE = 4.0 * du + dh
    Nu0 = N0 * u0
    dNu = dN * uc + N0 * du
    w_neg0 = Nu0 / E0
    dw_neg = (dNu - w_neg0 * dE) / Ec

    # w, positive-d branch: w = (g - 4 + sqrt(g^2 + q)) / 2
    gp0 = torch.where(g0 > 0, g0, 1.0)
    gpc = torch.where(gc > 0, gc, 1.0)
    dgp = torch.where((g0 > 0) & (gc > 0), dg, gpc - gp0)
    S0 = torch.sqrt(gp0 * gp0 + q0)
    Sc = torch.sqrt(gpc * gpc + qc)
    dS = ((gp0 + gpc) * dgp + dq) / (S0 + Sc)
    dw_pos = (dgp + dS) / 2.0

    neg0 = d0 < 0
    negc = d_c < 0
    w_abs0 = torch.where(neg0, w_neg0, (gp0 - 4.0 + S0) / 2.0)
    dw = torch.where(neg0 & negc, dw_neg,
                     torch.where((~neg0) & (~negc), dw_pos, _NAN))
    w_absc = torch.where(negc, (2.0 * sumc * sumc / lam) / gnc
                         / (1.0 + 4.0 / gnc + hc),
                         (gpc - 4.0 + Sc) / 2.0)
    dw = torch.where(torch.isnan(dw), w_absc - w_abs0, dw)

    root0 = torch.sqrt(torch.clamp(w_abs0 * (w_abs0 + 4.0), min=0.0))
    rootc = torch.sqrt(torch.clamp(w_absc * (w_absc + 4.0), min=0.0))
    droot = (w_abs0 + w_absc + 4.0) * dw / (root0 + rootc + _TINY)

    def guard(den):
        return torch.where(torch.abs(den) < _TINY, _TINY, den)

    def d_heads_std(s0_, sc_, ds_):
        den0 = guard(s0_ * (s0_ + 2.0))
        denc = guard(sc_ * (sc_ + 2.0))
        dden = (s0_ + sc_ + 2.0) * ds_
        x10 = (ze0 * (s0_ + 1.0) ** 2 + zn0 * (s0_ + 1.0)) / den0
        x20 = (zn0 * (s0_ + 1.0) ** 2 + ze0 * (s0_ + 1.0)) / den0
        dsq = (s0_ + sc_ + 2.0) * ds_          # d (s+1)^2
        dN1 = (dze * (sc_ + 1.0) ** 2 + ze0 * dsq
               + dzn * (sc_ + 1.0) + zn0 * ds_)
        dN2 = (dzn * (sc_ + 1.0) ** 2 + zn0 * dsq
               + dze * (sc_ + 1.0) + ze0 * ds_)
        dx1 = (dN1 - x10 * dden) / denc
        dx2 = (dN2 - x20 * dden) / denc
        dscale = ds_ / ((sc_ + 2.0) * (s0_ + 2.0))
        return dx1, dx2, dscale

    def d_heads_b(s0_, sc_, ds_):
        den0 = guard((s0_ - 1.0) * (s0_ + 1.0))
        denc = guard((sc_ - 1.0) * (sc_ + 1.0))
        dden = (s0_ + sc_) * ds_
        x10 = (ze0 * s0_ * s0_ + zn0 * s0_) / den0
        x20 = (zn0 * s0_ * s0_ + ze0 * s0_) / den0
        dsq = (s0_ + sc_) * ds_
        dN1 = dze * sc_ * sc_ + ze0 * dsq + dzn * sc_ + zn0 * ds_
        dN2 = dzn * sc_ * sc_ + zn0 * dsq + dze * sc_ + ze0 * ds_
        dx1 = (dN1 - x10 * dden) / denc
        dx2 = (dN2 - x20 * dden) / denc
        dscale = ds_ / ((sc_ + 1.0) * (s0_ + 1.0))
        return dx1, dx2, dscale

    # branch roots
    sa0 = (w_abs0 + root0) / 2.0
    sac = (w_absc + rootc) / 2.0
    dsa = (dw + droot) / 2.0
    sb0 = 2.0 / (w_abs0 + 2.0 + root0 + _TINY)
    sbc = 2.0 / (w_absc + 2.0 + rootc + _TINY)
    dsb = -2.0 * (dw + droot) / ((w_abs0 + 2.0 + root0 + _TINY)
                                 * (w_absc + 2.0 + rootc + _TINY))
    sc0_ = (w_abs0 - root0) / 2.0
    scc_ = (w_absc - rootc) / 2.0
    dsc_root = (dw - droot) / 2.0

    dxa = d_heads_std(sa0, sac, dsa)
    dxb = d_heads_b(sb0, sbc, dsb)
    dxc = d_heads_std(sc0_, scc_, dsc_root)
    same_pb = pb0 & pbc
    same_bb = bb0 & bbc
    same_cc = (~pb0) & (~pbc) & (~bb0) & (~bbc)

    def pick(k):
        return torch.where(same_pb, dxa[k], torch.where(
            same_bb, dxb[k], torch.where(same_cc, dxc[k], _NAN)))

    dx1, dx2, dsc = pick(0), pick(1), pick(2)

    # degenerate branch (sum_zz == 0): x2 = (-ze + sqrt(ze^2+4lam+zx))/2
    T0 = torch.sqrt(ze0 * ze0 + 4.0 * lam + zx0)
    Tc = torch.sqrt(ze * ze + 4.0 * lam + zx)
    dT = ((ze0 + ze) * dze + dzx) / (T0 + Tc)
    dx2_deg = (-dze + dT) / 2.0
    both_deg = dg0 & dgc
    dx1 = torch.where(both_deg, dx2_deg + dze, dx1)
    dx2 = torch.where(both_deg, dx2_deg, dx2)
    dsc = torch.where(both_deg, 0.0, dsc)

    # any remaining NaN (mismatch sentinel or genuine): direct difference
    dx1 = torch.where(torch.isnan(dx1), x1_c - x1_0, dx1)
    dx2 = torch.where(torch.isnan(dx2), x2_c - x2_0, dx2)
    dsc = torch.where(torch.isnan(dsc), sc_c - sc_0, dsc)
    return dx1, dx2, dsc


class _BlockAnchor(NamedTuple):
    """Per-block anchor values of a chunk: the head values, the body sum
    of squares and both chains at t0x (f32 recompute; constant through
    the chunk)."""

    a0: torch.Tensor
    S20: torch.Tensor
    bsq0: torch.Tensor
    soc0: tuple
    rsoc0: tuple
    sc0: torch.Tensor     # anchor body scale (coefficients only)


def _block_anchor(t0x, lam_x, bl: Blocks) -> _BlockAnchor:
    a0, S20, bsq0 = bl.head(t0x), bl.head2(t0x), bl.body_sum(t0x * t0x)
    soc0 = _soc_chain(a0, bsq0, lam_x)
    rsoc0 = _rsoc_chain(a0, S20, bsq0, lam_x)
    return _BlockAnchor(a0, S20, bsq0, soc0, rsoc0,
                        torch.where(bl.soc, soc0[9], rsoc0[2]))


def _cone_prox_delta(dtx, t0x, lam_x, co: ConeOperands, anchor=None):
    """P(dtx) = cone_prox(t0x + dtx) - cone_prox(t0x) on `(B, n)` f32
    rows, per cone type: orthant and SOC by stable delta chains, free is
    the identity, zero-cone coordinates stay 0.  `anchor`: the chunk's
    `_BlockAnchor`, when the caller holds it."""
    code = co.code
    out = _elementwise_prox(dtx, code, _prox_nn_delta(dtx, t0x, lam_x))
    if co.start.numel() == 0:
        return out
    bl = Blocks.of(co)
    k = _block_anchor(t0x, lam_x, bl) if anchor is None else anchor
    da, dS2 = bl.head(dtx), bl.head2(dtx)
    dbsq = bl.body_sum(2.0 * t0x * dtx + dtx * dtx)
    de_soc, dsc_soc = _soc_delta(k.a0, k.bsq0, da, dbsq, lam_x, k.soc0)
    dr1, dr2, dsc_r = _rsoc_delta(k.a0, k.S20, k.bsq0, da, dS2, dbsq, lam_x,
                                  k.rsoc0)
    dh1 = torch.where(bl.soc, de_soc, dr1)
    dsc = torch.where(bl.soc, dsc_soc, dsc_r)
    # body: x_b = sc * t_b  ->  dx_b = sc0 * dt_b + dsc * (t0_b + dt_b)
    g = lambda v: v[:, bl.blk]  # noqa: E731
    body = g(k.sc0) * dtx + g(dsc) * (t0x + dtx)
    blk_val = torch.where((code == E_SOC_H) | (code == E_RSOC_H1), g(dh1),
                          torch.where(code == E_RSOC_H2, g(dr2), body))
    return torch.where(code >= E_SOC_H, blk_val, out)


class ConicDeltaAnchor(NamedTuple):
    """f32 operands of one conic delta chunk, lane axis first (the cone
    structure travels beside it as `ConeOperands`)."""

    scal: torch.Tensor    # (B, 23) packed scalars, slots C_*
    A: torch.Tensor       # (B, m, n)
    Minv: torch.Tensor    # G^-1 (B, m, m) [Woodbury] or S^-1 (B, n, n)
    Hinv: torch.Tensor    # (B, n) Woodbury diagonal (zeros if primal)
    ry: torch.Tensor      # (B, m) pre_calculate r-vector blocks
    rx: torch.Tensor      # (B, n)
    b: torch.Tensor       # (B, m)
    c: torch.Tensor       # (B, n)
    Qd: torch.Tensor      # (B, n) diagonal Q (zeros if none)
    t0x: torch.Tensor     # prox argument anchor (f32 frame)
    etx: torch.Tensor     # rounding residue of t0x
    e_y: torch.Tensor     # y-update constant: rel_y0 - vy0 - y0
    e_x: torch.Tensor     # cone_prox(t0x) - x0
    e_vx: torch.Tensor    # x0 - rel_x0
    e_vy: torch.Tensor    # y0 - rel_y0
    Qz0: torch.Tensor     # Qd * zx0  (tau-quadratic c-coefficient)
    Qx0: torch.Tensor     # Qd * x0   (inner-criterion N = x'Qx)
    e0y: torch.Tensor     # (Qu_y - von_y)(anchor)
    e0x: torch.Tensor     # (Qu_x - von_x)(anchor)
    Qu0y: torch.Tensor    # Qu_y(anchor)   (norm cross-terms)
    Qu0x: torch.Tensor
    von0y: torch.Tensor   # rho_y * vy0
    von0x: torch.Tensor   # rho_x * vx0


# scal slots, the reference's order (`conic_delta.py:399-403`)
(C_RHOY, C_RHOX, C_RHOT, C_ACOEF, C_LAM, C_ALPHA, C_THRESH, C_QINIT, C_B0,
 C_C0, C_S0, C_TAU0, C_KAP0, C_T0T, C_ETT, C_ETAU, C_EVTAU, C_N0T, C_E0T,
 C_QU0T, C_QN0, C_VN0, C_TAUT0) = range(23)
N_DELTA_SCAL = 23
# output row: [dtau, dkappa, err, t_done]
DELTA_ROW = 4
_DELTA_M = ("ry", "b", "e_y", "e_vy", "e0y", "Qu0y", "von0y")


def _conic_delta_compute(anc: ConicDeltaAnchor, co: ConeOperands, t_max, *,
                         probe, woodbury):
    """The plain PyTorch version of the conic delta chunk kernel.

    Lane b runs trips of `probe` iterations while `t < t_max[b]` and its
    delta-frame inner criterion is `>= thresh` (entry value `q_init`);
    stopped lanes are frozen by mask.  Returns (dy, dx, dvy, dvx, row)
    with row `(B, 4)` = [dtau, dkappa, err, t_done], in the anchor's
    dtype."""
    _need_ieee(anc.A)
    sc = anc.scal

    def col(k):
        return sc[:, k:k + 1]

    rho_y, rho_x, rho_tau = col(C_RHOY), col(C_RHOX), col(C_RHOT)
    a_coef, lam, alpha, thresh = (col(C_ACOEF), col(C_LAM), col(C_ALPHA),
                                  col(C_THRESH))
    b0s, c0s, s0s = col(C_B0), col(C_C0), col(C_S0)
    tau0, kap0, t0t, ett = col(C_TAU0), col(C_KAP0), col(C_T0T), col(C_ETT)
    etau, evtau, N0t = col(C_ETAU), col(C_EVTAU), col(C_N0T)
    e0t, Qu0t, qn0, vn0 = col(C_E0T), col(C_QU0T), col(C_QN0), col(C_VN0)
    inv_ry = 1.0 / rho_y
    lam_x = lam / rho_x
    lam_tau = lam / rho_tau
    A = anc.A
    anchor = (_block_anchor(anc.t0x, lam_x, Blocks.of(co))
              if co.start.numel() else None)

    def iter_body(dy, dx, dvy, dvx, dtau, dkap):
        dwy = rho_y * (dy + dvy)
        dwx = rho_x * (dx + dvx)
        deta = rho_tau * (dtau + dkap)
        drhs = dwx + inv_ry * _rmv(A, dwy)
        dzx = solve_S(A, anc.Minv, anc.Hinv, drhs, woodbury)
        dzy = inv_ry * (dwy - _mv(A, dzx))
        db = (_bsum(anc.ry * dwy) + _bsum(anc.rx * dwx)
              - 2.0 * (rho_y * _bsum(anc.ry * dzy)
                       + rho_x * _bsum(anc.rx * dzx)) - deta)
        dc = -(2.0 * _bsum(anc.Qz0 * dzx) + _bsum(dzx * anc.Qd * dzx))
        bc = b0s + db
        cc = c0s + dc
        s_cur = torch.sqrt(torch.clamp(bc * bc - 4.0 * a_coef * cc, min=0.0))
        ds = ((b0s + bc) * db - 4.0 * a_coef * dc) / (s_cur + s0s + _TINY)
        dtau_t = (-db + ds) / (2.0 * a_coef)
        duty = dzy - dtau_t * anc.ry
        dutx = dzx - dtau_t * anc.rx
        drel_y = alpha * duty + (1.0 - alpha) * dy
        drel_x = alpha * dutx + (1.0 - alpha) * dx
        drel_t = alpha * dtau_t + (1.0 - alpha) * dtau
        dty = drel_y - dvy
        dtx = drel_x - dvx + anc.etx
        dtt = drel_t - dkap + ett
        dy_n = anc.e_y + dty
        dx_n = anc.e_x + _cone_prox_delta(dtx, anc.t0x, lam_x, co, anchor)
        dtau_n = etau + _prox_nn_delta(dtt, t0t, lam_tau)
        dvy_n = dvy + dy_n - drel_y + anc.e_vy
        dvx_n = dvx + dx_n - drel_x + anc.e_vx
        dkap_n = dkap + dtau_n - drel_t + evtau
        return (dy_n, dx_n, dvy_n, dvx_n, dtau_n, dkap_n)

    def err_delta(dy, dx, dvy, dvx, dtau, dkap):
        dQy = _mv(A, dx) - anc.b * dtau
        dQx = anc.Qd * dx - _rmv(A, dy) + anc.c * dtau
        # N = x'Qx; Qu_tau = -N/tau + y.b - x.c
        dN = 2.0 * _bsum(anc.Qx0 * dx) + _bsum(dx * anc.Qd * dx)
        tau = tau0 + dtau
        tau_safe = torch.where(torch.abs(tau) < _EPS_TAU, _EPS_TAU, tau)
        dQt = (-(dN - N0t * dtau) / tau_safe
               + _bsum(dy * anc.b) - _bsum(dx * anc.c))
        dvony = rho_y * dvy
        dvonx = rho_x * dvx
        dvont = rho_tau * dkap
        r1 = anc.e0y + dQy - dvony
        r2 = anc.e0x + dQx - dvonx
        r3 = e0t + dQt - dvont
        d2 = _bsum(r1 * r1) + _bsum(r2 * r2) + r3 * r3
        qn = torch.sqrt(torch.clamp(
            qn0 * qn0 + 2.0 * (_bsum(anc.Qu0y * dQy) + _bsum(anc.Qu0x * dQx)
                               + Qu0t * dQt)
            + _bsum(dQy * dQy) + _bsum(dQx * dQx) + dQt * dQt, min=0.0))
        vn = torch.sqrt(torch.clamp(
            vn0 * vn0 + 2.0 * (_bsum(anc.von0y * dvony)
                               + _bsum(anc.von0x * dvonx)
                               + rho_tau * kap0 * dvont)
            + _bsum(dvony * dvony) + _bsum(dvonx * dvonx) + dvont * dvont,
            min=0.0))
        return torch.sqrt(torch.clamp(d2, min=0.0)) / (1.0 + qn + vn)

    B, dev, dt = A.shape[0], A.device, A.dtype
    t_max = t_max.to(device=dev, dtype=torch.int32).reshape(B, 1)
    zy = torch.zeros_like(anc.e_y)
    zx = torch.zeros_like(anc.e_x)
    zs = torch.zeros((B, 1), dtype=dt, device=dev)
    state = (zy, zx, zy, zx, zs, zs)
    t = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    e = col(C_QINIT).clone()
    while True:
        run = (t < t_max) & (e >= thresh)
        if not bool(run.any()):
            break
        new = state
        for _ in range(probe):
            new = iter_body(*new)
        e_new = err_delta(*new)
        state = tuple(torch.where(run, a, s) for a, s in zip(new, state))
        t = torch.where(run, t + probe, t)
        e = torch.where(run, e_new, e)
    dy, dx, dvy, dvx, dtau, dkap = state
    return dy, dx, dvy, dvx, torch.cat([dtau, dkap, e, t.to(dt)], dim=1)


def conic_delta_cuda(anc: ConicDeltaAnchor, co: ConeOperands, t_max, *,
                     probe, woodbury):
    """The chunk on the card: one launch of `csrc/conic_delta.cu` over
    the lanes.  Same contract as `_conic_delta_compute`.  Raises on an
    operand the kernel does not take and on a refused launch; never
    falls back."""
    B, m, n = anc.A.shape
    dev = anc.A.device
    if dev.type != "cuda":
        raise ValueError(f"conic_delta_cuda needs CUDA tensors; got {dev}")
    if B < 1 or m < 1 or n < 1 or probe < 1:
        raise ValueError(f"empty chunk: B={B} m={m} n={n} probe={probe}")
    mk = m if woodbury else n
    want = {k: (f32, (B, m if k in _DELTA_M else n))
            for k in ConicDeltaAnchor._fields}
    want.update(scal=(f32, (B, N_DELTA_SCAL)), A=(f32, (B, m, n)),
                Minv=(f32, (B, mk, mk)), t_max=(torch.int32, (B,)))
    t_max = t_max.to(device=dev, dtype=torch.int32).contiguous()
    check_operands(list(anc._asdict().items()) + [("t_max", t_max)], want,
                   dev)
    outs = [torch.empty((B, k), dtype=f32, device=dev)
            for k in (m, n, m, n, DELTA_ROW)]
    launch("conic_delta", list(anc) + [t_max] + _cone_kernel_inputs(co, dev),
           outs, B, m, n, co.start.shape[0], probe, 1.0, woodbury, dev,
           DELTA_ROW)
    conic_delta_cuda.launches += 1
    return tuple(outs)


conic_delta_cuda.launches = 0


def conic_delta_anchor(A64, solve_fn, Qd64, ry64, rx64, b64, c64, a_coef,
                       rho_y, rho_x, rho_tau, lam, alpha, thresh, u, v,
                       q_init, layout, A32, Minv32, Hinv32
                       ) -> ConicDeltaAnchor:
    """Build the f32 operand set of one conic delta chunk from the f64
    entry state of every lane.  `solve_fn(w_y, w_x)` is the f64-quality
    DR linear solve (`DenseSchurSolver.solve`); the anchor images
    replicate one absolute DR iteration (`source/abip.c:186-314`) at the
    exact entry state.  a_coef, lam, thresh, q_init: floats or `(B,)`.

    NOTE: the first-ever DR iteration's `tau_t := 1` special case is NOT
    represented: this engine is an endgame, entered at k > 0."""
    B, m, n = A64.shape
    a_coef, lam, thresh, q_init = (_per_lane(x, B, u)
                                   for x in (a_coef, lam, thresh, q_init))
    y0, x0, tau0 = u[:, :m], u[:, m:m + n], u[:, m + n]
    vy0, vx0, kap0 = v[:, :m], v[:, m:m + n], v[:, m + n]
    lam_x = lam / rho_x
    lam_tau = lam / rho_tau

    wy0 = rho_y * (y0 + vy0)
    wx0 = rho_x * (x0 + vx0)
    eta0 = rho_tau * (tau0 + kap0)
    zy0, zx0 = solve_fn(wy0, wx0)
    Qd_ = torch.zeros_like(x0) if Qd64 is None else Qd64
    dot = lambda a, b: (a * b).sum(-1)  # noqa: E731
    b0 = (dot(ry64, wy0) + dot(rx64, wx0)
          - 2.0 * (rho_y * dot(ry64, zy0) + rho_x * dot(rx64, zx0)) - eta0)
    c0 = -dot(zx0, Qd_ * zx0)
    s0 = torch.sqrt(torch.clamp(b0 * b0 - 4.0 * a_coef * c0, min=0.0))
    tau_t0 = (-b0 + s0) / (2.0 * a_coef)
    uty0 = zy0 - tau_t0[:, None] * ry64
    utx0 = zx0 - tau_t0[:, None] * rx64
    rel_y0 = alpha * uty0 + (1.0 - alpha) * y0
    rel_x0 = alpha * utx0 + (1.0 - alpha) * x0
    rel_t0 = alpha * tau_t0 + (1.0 - alpha) * tau0
    e_y = rel_y0 - vy0 - y0
    t0x_32 = (rel_x0 - vx0).to(f32)
    etx = (rel_x0 - vx0) - t0x_32.to(f64)
    x_a = cone_barrier_prox(t0x_32.to(f64), lam_x[:, None], layout)
    e_x = x_a - x0
    e_vx = x0 - rel_x0
    e_vy = y0 - rel_y0
    t0t_32 = (rel_t0 - kap0).to(f32)
    ett = (rel_t0 - kap0) - t0t_32.to(f64)
    t0t64 = t0t_32.to(f64)
    sat = torch.sqrt(t0t64 * t0t64 + 4.0 * lam_tau)
    tau_a = torch.where(t0t64 >= 0, 0.5 * (t0t64 + sat),
                        2.0 * lam_tau / (sat - t0t64))
    etau = tau_a - tau0
    evtau = tau0 - rel_t0

    # inner-criterion anchors (`qcp_config.c:518-557`)
    Mu_y0 = _mv(A64, x0)
    Mu_x0 = Qd_ * x0 - _rmv(A64, y0)
    Qu_y0 = Mu_y0 - b64 * tau0[:, None]
    Qu_x0 = Mu_x0 + c64 * tau0[:, None]
    N0 = dot(x0, Qd_ * x0)
    tau_safe0 = torch.where(torch.abs(tau0) < _EPS_TAU,
                            torch.full_like(tau0, _EPS_TAU), tau0)
    Qu_t0 = -N0 / tau_safe0 + dot(y0, b64) - dot(x0, c64)
    von_y0 = rho_y * vy0
    von_x0 = rho_x * vx0
    von_t0 = rho_tau * kap0
    e0y = Qu_y0 - von_y0
    e0x = Qu_x0 - von_x0
    e0t = Qu_t0 - von_t0
    qn0 = torch.sqrt(dot(Qu_y0, Qu_y0) + dot(Qu_x0, Qu_x0) + Qu_t0 * Qu_t0)
    vn0 = torch.sqrt(dot(von_y0, von_y0) + dot(von_x0, von_x0)
                     + von_t0 * von_t0)

    scal = torch.stack([_per_lane(s, B, u) for s in (
        rho_y, rho_x, rho_tau, a_coef, lam, alpha, thresh, q_init, b0, c0,
        s0, tau0, kap0, t0t64, ett, etau, evtau, N0 / tau_safe0, e0t, Qu_t0,
        qn0, vn0, tau_t0)], dim=1).to(f32)

    def row(x):
        return x.to(f32).contiguous()

    return ConicDeltaAnchor(
        scal=scal, A=A32.contiguous(), Minv=Minv32.contiguous(),
        Hinv=row(Hinv32), ry=row(ry64), rx=row(rx64), b=row(b64),
        c=row(c64), Qd=row(Qd_), t0x=t0x_32.contiguous(), etx=row(etx),
        e_y=row(e_y), e_x=row(e_x), e_vx=row(e_vx), e_vy=row(e_vy),
        Qz0=row(Qd_ * zx0), Qx0=row(Qd_ * x0), e0y=row(e0y), e0x=row(e0x),
        Qu0y=row(Qu_y0), Qu0x=row(Qu_x0), von0y=row(von_y0),
        von0x=row(von_x0))


class ConicDeltaResult(NamedTuple):
    u: torch.Tensor        # (B, m + n + 1) f64 iterate after the chunk
    v: torch.Tensor
    t_done: torch.Tensor   # (B,) int32 iterations executed
    err: torch.Tensor      # (B,) f64 delta-frame inner criterion


def run_conic_delta_chunk(A64, solve_fn, Qd64, ry64, rx64, b64, c64, a_coef,
                          rho_y, rho_x, rho_tau, lam, alpha, thresh, u, v,
                          q_init, layout, co, A32, Minv32, Hinv32, woodbury,
                          *, T, probe, active=None) -> ConicDeltaResult:
    """One anchored-delta conic chunk for every lane: the f64 anchor, up
    to T f32 iterations stopping at err < thresh, the f64 state.

    `active` (`(B,)` bool) gives inactive lanes zero iterations.  On CPU
    tensors the plain version runs; on CUDA tensors the kernel, or it
    raises."""
    B, m, n = A64.shape
    if A64.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conic delta chunk for device {A64.device}")
    anc = conic_delta_anchor(A64, solve_fn, Qd64, ry64, rx64, b64, c64,
                             a_coef, rho_y, rho_x, rho_tau, lam, alpha,
                             thresh, u, v, q_init, layout, A32, Minv32,
                             Hinv32)
    t_max = torch.full((B,), T, dtype=torch.int32, device=A64.device)
    if active is not None:
        t_max = torch.where(active, t_max, 0).to(torch.int32)
    chunk = conic_delta_cuda if A64.is_cuda else _conic_delta_compute
    dy, dx, dvy, dvx, row = chunk(anc, co, t_max, probe=probe,
                                  woodbury=woodbury)
    row = row.to(f64)
    u_new = torch.cat([u[:, :m] + dy.to(f64), u[:, m:m + n] + dx.to(f64),
                       (u[:, m + n] + row[:, 0])[:, None]], dim=1)
    v_new = torch.cat([v[:, :m] + dvy.to(f64), v[:, m:m + n] + dvx.to(f64),
                       (v[:, m + n] + row[:, 1])[:, None]], dim=1)
    return ConicDeltaResult(u=u_new, v=v_new,
                            t_done=row[:, 3].to(torch.int32), err=row[:, 2])


def conic_anchor_from_numpy(fields, m, n, woodbury, device=None
                            ) -> ConicDeltaAnchor:
    """The reference's `ConicDeltaAnchor` (numpy arrays, one lane or
    batched, padded to 128) as the port's: padding dropped, the scalar
    row cut to its 23 slots, the `cd` field left out (the port's cone
    operands come from the spec, `cones.cone_operands`)."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    mk = m if woodbury else n
    out = {}
    for name in ConicDeltaAnchor._fields:
        x = fields[name]
        if name == "scal":
            dims = (N_DELTA_SCAL,)
        elif name == "A":
            dims = (m, n)
        elif name == "Minv":
            dims = (mk, mk)
        else:
            dims = (m if name in _DELTA_M else n,)
        out[name] = torch.from_numpy(np.ascontiguousarray(
            _unpad(x, dims))).to(device)
    return ConicDeltaAnchor(**out)
