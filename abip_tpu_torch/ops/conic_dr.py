"""Fused conic DR engines: the barrier ladder and the one-stage sprint.

Port of `abip_tpu/ops/conic_pallas.py`: the ladder entry
`fused_dr_ladder` (conic phase 1 in one launch per batch) and the
sprint entry `fused_dr_sprint_stop` (up to T iterations at one fixed
barrier, stopping on the inner criterion), and what they need.

The ladder: up to T f32 Douglas-Rachford
iterations per lane -- projection with the quadratic-formula tau
(`source/abip.c:186-254`), cone barrier prox (`source/cones.c:130-289`),
dual update (`source/abip.c:314`) -- across as many barrier stages as
fit: every `probe` iterations the f32 inner criterion
(`qcp_inner_conv_check`, `qcp_config.c:518-557`) and the f32 error ratio
(`calc_qcp_residuals`) feed the in-kernel `adjust_barrier` tables
(`source/abip.c:994-1071`), and the lane stops once mu < mu_stop.

`_dr_ladder_compute` and `_dr_sprint_compute` are the plain PyTorch
versions (CPU tensors, and the references the kernels are held to);
`csrc/conic_ladder.cu` and `csrc/conic_sprint.cu` are the CUDA kernels,
one thread-block cluster per lane on the shared iteration of
`csrc/conic_cluster.cuh` (`dr_launch_plan`: the cluster size, A's column
slice resident in shared memory or streamed through L2, or the layout
spilled to a global workspace where no shared memory holds a CTA, so that
they take every shape).  The entries take the plain version on CPU
tensors and the kernel on CUDA tensors.

Layout: lane axis first, no padding.  Rows are `(B, m)`/`(B, n)` f32,
`A` is `(B, m, n)`, `Minv` is G^-1 `(B, m, m)` (Woodbury form, with the
diagonal H^-1 in `Hinv`) or S^-1 `(B, n, n)` (primal form).  The cone
structure, shared by every lane, travels as per-element class codes and
per-block (start, length, type) rows (`ConeOperands`), not as the TPU
kernel's 0/1 indicator matrices; block sums are gathers with a fixed
reduction order.  The f32 guards are the TPU kernel's (`_TINY = 1e-30`,
`_SOC_TOL = 1e-6`, `_EPS_TAU = 1e-18`), not the f64 prox's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..cones import E_FREE, E_NN, E_SOC_H, Blocks, ConeOperands
from ..device import smem_optin
from .admm_delta import (SMEM_OPTIN, DeltaPlan, _cuda_error, _mv, _per_lane,
                         _rmv, check_plan, cluster_workspace,
                         delta_cols_per_cta)

f32 = torch.float32
f64 = torch.float64
_TINY = 1e-30
_SOC_TOL = 1e-6
_EPS_TAU = 1e-18


def _bsum(x):
    return x.sum(-1, keepdim=True)


def _bmax(x):
    return torch.abs(x).amax(-1, keepdim=True)


def _full(like, v):
    return torch.full_like(like, v)


def _prox_nn(t, lam):
    """Positive-orthant barrier prox (`cones.c:279-289`), branch-free."""
    pos = 0.5 * (t + torch.sqrt(t * t + 4.0 * lam))
    neg = 2.0 * lam / (
        -t * (1.0 + torch.sqrt(1.0 + 4.0 * lam / (t * t + _TINY))) + _TINY)
    return torch.where(t >= 0, pos, neg)


def _soc_rows(a, bsq, lam):
    """SOC barrier prox per block (`cones.c:130-161`) on `(B, nb)` block
    scalars.  Returns (head_value, body_scale)."""
    x0_zero = torch.sqrt(2.0 * lam + bsq / 4.0)
    denom_r = 8.0 * lam - a * a + bsq
    r = 16.0 * a * a / (
        denom_r + torch.sqrt(denom_r * denom_r + 32.0 * a * a * lam) + _TINY)
    disc = torch.sqrt(torch.clamp(r * (r + 8.0), min=0.0))
    s = torch.where(a > 0, (r + disc) / 2.0, (r - disc) / 2.0)
    s_safe = torch.where(torch.abs(s) < _TINY, _full(s, _TINY), s)
    eta = (s + 2.0) * a / s_safe
    scale_pos = (s + 2.0) / (s + 4.0)
    small = torch.abs(a) <= _SOC_TOL
    return (torch.where(small, x0_zero, eta),
            torch.where(small, _full(scale_pos, 0.5), scale_pos))


def _rsoc_rows(ze, zn, zxsq, lam):
    """RSOC barrier prox per block (`cones.c:169-248`) on `(B, nb)`
    block scalars.  Returns (head1, head2, body_scale)."""
    sum_zz = ze + zn
    d = 2.0 * ze * zn - zxsq
    g = d / (2.0 * lam)
    g_neg = torch.where(g < 0, -g, _full(g, 1.0))
    g_pos = torch.where(g > 0, g, _full(g, 1.0))
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

    def guard(den):
        return torch.where(torch.abs(den) < _TINY, _full(den, _TINY), den)

    def heads_std(s):
        den = guard(s * (s + 2.0))
        x1 = (ze * (s + 1.0) ** 2 + zn * (s + 1.0)) / den
        x2 = (zn * (s + 1.0) ** 2 + ze * (s + 1.0)) / den
        return x1, x2, (s + 1.0) / (s + 2.0)

    def heads_b(s):
        den = guard((s - 1.0) * (s + 1.0))
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
    sc = torch.where(deg, _full(sc, 0.5), sc)
    return x1, x2, sc


def _elementwise_prox(tx, code, prox_nn):
    """The scalar classes of a prox row: orthant -> `prox_nn`, free ->
    the identity, zero (and block elements, set later) -> 0."""
    out = torch.where(code == E_NN, prox_nn, torch.zeros_like(tx))
    return torch.where(code == E_FREE, tx, out)


def _cone_prox(tx, lam_x, co: ConeOperands):
    """Full cone barrier prox on `(B, n)` f32 rows, lam_x `(B, 1)`."""
    code = co.code
    out = _elementwise_prox(tx, code, _prox_nn(tx, lam_x))
    if co.start.numel() == 0:
        return out
    bl = Blocks.of(co)
    a, s2, sb = bl.head(tx), bl.head2(tx), bl.body_sum(tx * tx)
    soc_h, soc_s = _soc_rows(a, sb, lam_x)
    rs1, rs2, rs_s = _rsoc_rows(a, s2, sb, lam_x)
    h1 = torch.where(bl.soc, soc_h, rs1)
    scv = torch.where(bl.soc, soc_s, rs_s)
    return torch.where(code >= E_SOC_H, bl.scatter(h1, rs2, scv, tx, code),
                       out)


def _need_ieee(t):
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the conic f32 iterations need IEEE f32 matmuls: "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")


def solve_S(A, Minv, Hinv, rhs, woodbury):
    """z_x = S^-1 rhs in f32 through the explicit inverse the kernels
    hold: G^-1 with the Woodbury identity, or S^-1 (`rhs @ S^-1`, as
    the reference applies it)."""
    if woodbury:
        t = Hinv * rhs
        u = _mv(Minv, _mv(A, t))
        return t - Hinv * _rmv(A, u)
    return _rmv(Minv, rhs)


# ---------------------------------------------------------------------------
# ladder
# ---------------------------------------------------------------------------

def _adjust_barrier_f32(mu, err_ratio, eps, psi):
    """`adjust_barrier` (`source/abip.c:994-1071`) as f32 selects on
    `(B, 1)` tensors (the tables unrolled into where-chains)."""
    from ..conic_ops import (_ERR_EDGES, _GMUL_VALS, _RATIO_EDGES,
                             _RATIO_VALS, _SIG_VALS)

    ratio = mu / eps
    gamma = _full(mu, _RATIO_VALS[0])
    for e, v in zip(_RATIO_EDGES, _RATIO_VALS[1:]):
        gamma = torch.where(ratio >= e, _full(mu, v), gamma)
    gm = _full(mu, _GMUL_VALS[0])
    sg = _full(mu, _SIG_VALS[0])
    for e, gv, sv in zip(_ERR_EDGES, _GMUL_VALS[1:], _SIG_VALS[1:]):
        gm = torch.where(err_ratio >= e, _full(mu, gv), gm)
        sg = torch.where(err_ratio >= e, _full(mu, sv), sg)
    mu_new = sg * 0.2 * mu
    tol = gamma * gm * (mu_new if psi == 1.0 else mu_new ** psi)
    return mu_new, tol


# ladder scal slots, the reference's order (`conic_pallas.py:581-583`)
(L_RHOY, L_RHOX, L_RHOT, L_ACOEF, L_MU, L_ALPHA, L_TAU, L_KAPPA, L_TOL,
 L_K0, L_MUSTOP, L_EPS, L_SCB, L_SCC, L_NMB, L_NMC) = range(16)
N_LADDER_SCAL = 16
# output row: [tau, kappa, err, t_done, mu, tol, stages]
LADDER_ROW = 7


class LadderOperands(NamedTuple):
    """f32 operands of one ladder launch, lane axis first."""

    scal: torch.Tensor    # (B, 16) per-lane scalars, slots L_*
    A: torch.Tensor       # (B, m, n)
    Minv: torch.Tensor    # G^-1 (B, m, m) or S^-1 (B, n, n)
    Hinv: torch.Tensor    # (B, n) Woodbury diagonal (zeros in the primal form)
    ry: torch.Tensor      # (B, m) pre_calculate r-vector blocks
    rx: torch.Tensor      # (B, n)
    b: torch.Tensor       # (B, m)
    c: torch.Tensor       # (B, n)
    Qd: torch.Tensor      # (B, n) diagonal Q (zeros when absent)
    D: torch.Tensor       # (B, m) equilibration scalings
    E: torch.Tensor       # (B, n)
    y: torch.Tensor       # (B, m) entry iterate
    x: torch.Tensor       # (B, n)
    vy: torch.Tensor      # (B, m)
    vx: torch.Tensor      # (B, n)


_LADDER_M = ("ry", "b", "D", "y", "vy")


def _make_dr_fns(op, co, rho_y, rho_x, rho_tau, a_coef, alpha, k0,
                 woodbury):
    """`iter_body(lam, i, state)`: one conic DR iteration at barrier lam
    (i the launch-local iteration index, `(B, 1)`), and
    `err_inner(state)`: `qcp_inner_conv_check` in f32."""
    A, ry, rx, b, c, Qd = op.A, op.ry, op.rx, op.b, op.c, op.Qd
    inv_ry = 1.0 / rho_y

    def iter_body(lam, i, state):
        y, x, vy, vx, tau, kappa = state
        lam_x = lam / rho_x
        lam_tau = lam / rho_tau
        wy = rho_y * (y + vy)
        wx = rho_x * (x + vx)
        eta = rho_tau * (tau + kappa)
        rhs = wx + inv_ry * _rmv(A, wy)           # w_x + A'(w_y/rho_y)
        zx = solve_S(A, op.Minv, op.Hinv, rhs, woodbury)
        zy = inv_ry * (wy - _mv(A, zx))
        b_coef = (_bsum(ry * wy) + _bsum(rx * wx)
                  - 2.0 * (rho_y * _bsum(ry * zy) + rho_x * _bsum(rx * zx))
                  - eta)
        c_coef = -_bsum(zx * Qd * zx)
        disc = torch.clamp(b_coef * b_coef - 4.0 * a_coef * c_coef, min=0.0)
        tau_t = (-b_coef + torch.sqrt(disc)) / (2.0 * a_coef)
        tau_t = torch.where(k0 + i.to(f32) > 0, tau_t, _full(tau_t, 1.0))
        uty = zy - tau_t * ry
        utx = zx - tau_t * rx
        rel_y = alpha * uty + (1.0 - alpha) * y
        rel_x = alpha * utx + (1.0 - alpha) * x
        rel_tau = alpha * tau_t + (1.0 - alpha) * tau
        y_new = rel_y - vy                        # free-cone head
        x_new = _cone_prox(rel_x - vx, lam_x, co)
        tau_new = _prox_nn(rel_tau - kappa, lam_tau)
        vy_new = vy + y_new - rel_y
        vx_new = vx + x_new - rel_x
        kappa_new = kappa + tau_new - rel_tau
        return (y_new, x_new, vy_new, vx_new, tau_new, kappa_new)

    def err_inner(y, x, vy, vx, tau, kappa):
        Mu_y = _mv(A, x)
        Mu_x = Qd * x - _rmv(A, y)
        Qu_y = Mu_y - b * tau
        Qu_x = Mu_x + c * tau
        tau_safe = torch.where(torch.abs(tau) < _EPS_TAU,
                               _full(tau, _EPS_TAU), tau)
        Qu_tau = (-(_bsum(y * Mu_y) + _bsum(x * Mu_x)) / tau_safe
                  + _bsum(y * b) - _bsum(x * c))
        von_y = rho_y * vy
        von_x = rho_x * vx
        von_tau = rho_tau * kappa
        d2 = (_bsum((Qu_y - von_y) ** 2) + _bsum((Qu_x - von_x) ** 2)
              + (Qu_tau - von_tau) ** 2)
        qn = torch.sqrt(_bsum(Qu_y * Qu_y) + _bsum(Qu_x * Qu_x)
                        + Qu_tau * Qu_tau)
        vn = torch.sqrt(_bsum(von_y * von_y) + _bsum(von_x * von_x)
                        + von_tau * von_tau)
        return torch.sqrt(d2) / (1.0 + qn + vn)

    return iter_body, err_inner


def _dr_ladder_compute(op: LadderOperands, co: ConeOperands, t_max, *,
                       probe, psi, woodbury):
    """The plain PyTorch version of the ladder kernel.

    Lane b runs trips of `probe` iterations at its current mu while
    `t < t_max[b]` and `mu >= mu_stop`; after each trip the inner
    criterion decides whether (mu, tol) advance through the barrier
    tables.  Stopped lanes are frozen by mask.  Returns
    (y, x, vy, vx, row) with row `(B, 7)` =
    [tau, kappa, err, t_done, mu, tol, stages], in the operands' dtype
    (f32 as the kernel, or f64 to measure the f32 versions' error)."""
    _need_ieee(op.A)
    sc = op.scal

    def col(k):
        return sc[:, k:k + 1]

    rho_y, rho_x, rho_tau = col(L_RHOY), col(L_RHOX), col(L_RHOT)
    a_coef, alpha, k0 = col(L_ACOEF), col(L_ALPHA), col(L_K0)
    mu_stop, eps = col(L_MUSTOP), col(L_EPS)
    sc_b, sc_c, nm_b, nm_c = col(L_SCB), col(L_SCC), col(L_NMB), col(L_NMC)
    A, b, c, Qd, D, E = op.A, op.b, op.c, op.Qd, op.D, op.E
    iter_body, err_inner = _make_dr_fns(op, co, rho_y, rho_x, rho_tau,
                                        a_coef, alpha, k0, woodbury)

    def error_ratio(y, x, vx, tau):
        """max(res/eps) of `calc_qcp_residuals` in f32."""
        tau_s = torch.clamp(torch.abs(tau), min=1e-18)
        xs = x / tau_s
        ys = y / tau_s
        ss = rho_x * vx / tau_s
        Ax = _mv(A, xs)
        DAx = D * Ax
        res_pri = _bmax(D * (Ax - b)) / (
            sc_b + torch.maximum(_bmax(DAx), sc_b * nm_b))
        Qx = Qd * xs
        dres = Qx - _rmv(A, ys) + c - ss
        res_dual = _bmax(E * dres) / (
            sc_c + torch.maximum(sc_c * nm_c, _bmax(E * Qx)))
        inv_bc = 1.0 / (sc_b * sc_c)
        xQx_2 = 0.5 * _bsum(xs * Qx) * inv_bc
        cTx = _bsum(c * xs) * inv_bc
        bTy = _bsum(b * ys) * inv_bc
        rel_gap = torch.abs(2.0 * xQx_2 + cTx - bTy) / (
            1.0 + torch.maximum(2.0 * xQx_2,
                                torch.maximum(torch.abs(cTx),
                                              torch.abs(bTy))))
        return torch.maximum(res_pri, torch.maximum(res_dual, rel_gap)) / eps

    B, dev = A.shape[0], A.device
    t_max = t_max.to(device=dev, dtype=torch.int32).reshape(B, 1)
    state = (op.y, op.x, op.vy, op.vx, col(L_TAU), col(L_KAPPA))
    t = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    stages = torch.zeros_like(t)
    mu, tol = col(L_MU), col(L_TOL)
    e = _full(mu, float("inf"))
    while True:
        run = (t < t_max) & (mu >= mu_stop)
        if not bool(run.any()):
            break
        new = state
        for j in range(probe):
            new = iter_body(mu, t + j, new)
        e_new = err_inner(*new)
        y, x, vy, vx, tau, _ = new
        mu2, tol2 = _adjust_barrier_f32(mu, error_ratio(y, x, vx, tau), eps,
                                        psi)
        adv = run & (e_new < tol)
        state = tuple(torch.where(run, a, s) for a, s in zip(new, state))
        mu = torch.where(adv, mu2, mu)
        tol = torch.where(adv, tol2, tol)
        stages = stages + adv.to(torch.int32)
        t = torch.where(run, t + probe, t)
        e = torch.where(run, e_new, e)
    y, x, vy, vx, tau, kappa = state
    row = torch.cat([tau, kappa, e, t.to(e.dtype), mu, tol,
                     stages.to(e.dtype)], dim=1)
    return y, x, vy, vx, row


# ---------------------------------------------------------------------------
# the CUDA kernels' bindings (shared with ops/conic_delta.py)
# ---------------------------------------------------------------------------

# K2 and K4: CTAs of DR_THREADS threads, one cluster per lane
# (`csrc/conic_cluster.cuh`); the launch plans both kernels try, in order:
# (cluster size, A's slice resident), the last one also spilled.  At
# dim-1020 B=16 C=8 with A resident is the fastest form of both (PERF.md),
# though an H100 holds only 15 such clusters at once; where A's slice does
# not fit, C=6 streams with 17 clusters at once, then C=16.
DR_THREADS = 384
DR_PLANS = ((8, True), (6, False), (16, False))
# per-CTA layout (`conic_cluster.cuh:dr_smem_floats`)
_DR_SCRATCH = (DR_THREADS // 32) * 8 + 2 * 28 + 12  # reduction, slots, sums
_DR_XBUF = 2 * 2     # two exchanges' buffers of two partial m-vectors
_DR_XSTATE = 4       # x, vx, t, zx
_DR_BLKVALS = 4      # values per cone block that touches a CTA
_DR_MVECS = 5        # y, vy, wy, A t, zy (global where streaming)
_DR_MOPS = 3         # ry, b, D
_DR_XOPS = 5         # hinv, rx, qd, c, E


def _al4(x):
    return -(-x // 4) * 4


def dr_smem_bytes(m, n, nb, cluster, resident, woodbury=True):
    """Dynamic shared memory of one CTA of K2 and K4
    (`csrc/conic_cluster.cuh:dr_smem_floats`), every array padded to 16
    bytes: the scratch, two exchanges' buffers of two partial m-vectors,
    u, the four x-side state slices of nc = `delta_cols_per_cta`
    columns, the direct form's whole rhs (n), four values per cone block
    that touches the CTA (at most min(nb, nc)), the split column dots'
    partials (max(nc, 384)); resident, the five m-side state vectors and
    three m-side operands, A's slice (its rows at a stride of 4 mod 8
    floats) and five x-side operand slices."""
    nc = delta_cols_per_cta(n, cluster)
    mp = _al4(m)
    floats = (_DR_SCRATCH + (_DR_XBUF + 1) * mp + _DR_XSTATE * nc
              + (0 if woodbury else _al4(n)) + _al4(_DR_BLKVALS * min(nb, nc))
              + max(nc, DR_THREADS))
    if resident:
        floats += ((_DR_MVECS + _DR_MOPS) * mp + m * (nc + 4 * (nc % 8 == 0))
                   + _DR_XOPS * nc)
    return 4 * floats


def dr_launch_plan(m, n, nb, smem_limit=SMEM_OPTIN, woodbury=True):
    """The launch of K2 and K4 at shape (m, n) with nb cone blocks (a
    `DeltaPlan`: cluster size, residency, shared memory per CTA): the
    first of DR_PLANS whose CTA fits `smem_limit`, else the last one
    spilled, which takes every shape.  Where the reference runs its XLA
    version because its kernel does not fit VMEM
    (`abip_tpu/ops/conic_pallas.py:496`, `:805`), the port's kernels
    stream or spill."""
    if m < 1 or n < 1:
        raise ValueError(f"empty launch: m={m} n={n}")
    for cluster, resident in DR_PLANS:
        nbytes = dr_smem_bytes(m, n, nb, cluster, resident, woodbury)
        if nbytes <= smem_limit:
            return DeltaPlan(cluster, resident, nbytes)
    return DeltaPlan(DR_PLANS[-1][0], False, 0, spill=True)


@functools.lru_cache(maxsize=None)
def kernel_lib(name):
    """ctypes handle of `csrc/<name>.cu` (conic_ladder or conic_sprint),
    built at first use."""
    from .build import load

    lib = load(name).lib
    entry = getattr(lib, f"abip_{name}")
    entry.argtypes = ([ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
                      + [ctypes.c_int] * 5 + [ctypes.c_float]
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    entry.restype = ctypes.c_int
    smem = getattr(lib, f"abip_{name}_smem_bytes")
    smem.argtypes = [ctypes.c_int] * 7
    smem.restype = ctypes.c_longlong
    work = getattr(lib, f"abip_{name}_work_floats")
    work.argtypes = [ctypes.c_int] * 6
    work.restype = ctypes.c_longlong
    occ = getattr(lib, f"abip_{name}_max_active_clusters")
    occ.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    threads = getattr(lib, f"abip_{name}_threads")
    for fn in (lib.abip_row_width, threads):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.abip_cuda_error_string.argtypes = [ctypes.c_int]
    lib.abip_cuda_error_string.restype = ctypes.c_char_p
    if threads() != DR_THREADS or work(5, 1, 0, 1, 1, 0) != _DR_MVECS * 8:
        raise RuntimeError(f"csrc/{name}.cu and its wrapper disagree on the "
                           "threads or the workspace per CTA")
    return lib


@functools.lru_cache(maxsize=None)
def dr_max_active_clusters(name, m, n, nb, plan: DeltaPlan, woodbury=True,
                           device_index=0):
    """How many of the plan's clusters of `csrc/<name>.cu` the card holds
    at once (`cudaOccupancyMaxActiveClusters`).  A lane is one cluster;
    more lanes than this wait for a second wave."""
    lib = kernel_lib(name)
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(lib, f"abip_{name}_max_active_clusters")(
            m, n, nb, plan.cluster, int(plan.resident), int(woodbury),
            int(plan.spill), ctypes.byref(out))
    if err:
        raise _cuda_error(lib, f"{name} occupancy query failed", err)
    return out.value


def check_operands(named, want, dev):
    """Raise unless each tensor is contiguous, on `dev`, of the wanted
    dtype and shape (`want[name] = (dtype, shape)`)."""
    for name, x in named:
        dtype, shape = want[name]
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(
                f"operand {name}: need contiguous {dtype} {shape} on {dev}; "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def launch(name, ins, outs, B, m, n, nb, probe, psi, woodbury, dev,
           row_width, plan=None):
    """One launch of `csrc/<name>.cu` over B lanes, one cluster per lane,
    on the current stream, by `dr_launch_plan` (or `plan`); raises on a
    plan the card cannot hold and on a refused launch."""
    lib = kernel_lib(name)
    if lib.abip_row_width() != row_width:
        raise RuntimeError(f"csrc/{name}.cu and its wrapper disagree on the "
                           "output row width")
    limit = smem_optin(dev)
    if plan is None:
        plan = dr_launch_plan(m, n, nb, limit, woodbury)
    check_plan(plan, limit)
    if getattr(lib, f"abip_{name}_smem_bytes")(
            m, n, nb, plan.cluster, int(plan.resident), int(woodbury),
            int(plan.spill)) != plan.smem_bytes:
        raise RuntimeError(f"csrc/{name}.cu and its wrapper disagree on the "
                           "shared memory of a CTA")
    if dr_max_active_clusters(name, m, n, nb, plan, woodbury,
                              dev.index or 0) < 1:
        raise RuntimeError(
            f"the card cannot hold one cluster of {plan.cluster} CTAs with "
            f"{plan.smem_bytes} B of shared memory each (m={m} n={n})")
    # the streaming form keeps each CTA's m-side state in global memory,
    # the spilled form its whole layout
    work = cluster_workspace(getattr(lib, f"abip_{name}_work_floats"), B,
                             plan, dev, m, n, nb, int(woodbury))
    inp = (ctypes.c_void_p * len(ins))(*[x.data_ptr() for x in ins])
    outp = (ctypes.c_void_p * len(outs))(*[x.data_ptr() for x in outs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"abip_{name}")(
            inp, outp, None if work is None else work.data_ptr(), B, m, n,
            nb, probe, ctypes.c_float(psi), int(woodbury), plan.cluster,
            int(plan.resident), int(plan.spill), ctypes.c_void_p(stream))
    if err:
        raise _cuda_error(lib, f"{name} kernel launch failed", err)


def _cone_kernel_inputs(co, dev):
    n, nb = co.code.shape[0], co.start.shape[0]
    check_operands(
        [(k, getattr(co, k)) for k in ("code", "blk", "start", "length",
                                       "soc")],
        dict(code=(torch.int32, (n,)), blk=(torch.int32, (n,)),
             start=(torch.int32, (nb,)), length=(torch.int32, (nb,)),
             soc=(torch.int32, (nb,))), dev)
    return [co.code, co.blk, co.start, co.length, co.soc]


def ladder_cuda(op: LadderOperands, co: ConeOperands, t_max, *, probe, psi,
                woodbury, plan=None):
    """The ladder on the card: one launch of `csrc/conic_ladder.cu`, one
    thread-block cluster per lane, by `dr_launch_plan`.
    Same contract as `_dr_ladder_compute`.  `plan` (a `DeltaPlan`)
    replaces the launch plan, to time other cluster sizes and check other
    forms; the solvers never pass it.  Raises on an operand the kernel
    does not take, on a plan the card cannot hold and on a refused
    launch; never falls back."""
    B, m, n = op.A.shape
    dev = op.A.device
    if dev.type != "cuda":
        raise ValueError(f"ladder_cuda needs CUDA tensors; got {dev}")
    if B < 1 or m < 1 or n < 1 or probe < 1:
        raise ValueError(f"empty launch: B={B} m={m} n={n} probe={probe}")
    mk = m if woodbury else n
    want = {k: (f32, (B, m if k in _LADDER_M else n))
            for k in LadderOperands._fields}
    want.update(scal=(f32, (B, N_LADDER_SCAL)), A=(f32, (B, m, n)),
                Minv=(f32, (B, mk, mk)), t_max=(torch.int32, (B,)))
    t_max = t_max.to(device=dev, dtype=torch.int32).contiguous()
    check_operands(list(op._asdict().items()) + [("t_max", t_max)], want, dev)
    outs = [torch.empty((B, k), dtype=f32, device=dev)
            for k in (m, n, m, n, LADDER_ROW)]
    launch("conic_ladder", list(op) + [t_max] + _cone_kernel_inputs(co, dev),
           outs, B, m, n, co.start.shape[0], probe, psi, woodbury, dev,
           LADDER_ROW, plan)
    ladder_cuda.launches += 1
    return tuple(outs)


ladder_cuda.launches = 0


def ladder_operands(A32, Minv32, Hinv32, r_vec32, b32, c32, Qd32, D32, E32,
                    rho_y, rho_x, rho_tau, a_coef, mu, tol_inner, mu_stop,
                    eps, sc_b, sc_c, nm_inf_b, nm_inf_c, alpha, u32, v32,
                    k0) -> LadderOperands:
    """Pack the operands of one ladder launch (`fused_dr_ladder`'s
    arguments) as `LadderOperands`."""
    B, m, n = A32.shape
    scal = torch.stack([_per_lane(s, B, A32) for s in (
        rho_y, rho_x, rho_tau, a_coef, mu, alpha, u32[:, m + n],
        v32[:, m + n], tol_inner, k0, mu_stop, eps, sc_b, sc_c, nm_inf_b,
        nm_inf_c)], dim=1).to(f32)

    def row(x):
        return x.to(f32).contiguous()

    return LadderOperands(
        scal=scal, A=A32.contiguous(), Minv=Minv32.contiguous(),
        Hinv=row(Hinv32), ry=row(r_vec32[:, :m]), rx=row(r_vec32[:, m:]),
        b=row(b32), c=row(c32), Qd=row(Qd32), D=row(D32), E=row(E32),
        y=row(u32[:, :m]), x=row(u32[:, m:m + n]), vy=row(v32[:, :m]),
        vx=row(v32[:, m:m + n]))


def fused_dr_ladder(A32, Minv32, Hinv32, r_vec32, b32, c32, Qd32, D32, E32,
                    co: ConeOperands, rho_y, rho_x, rho_tau, a_coef, mu,
                    tol_inner, mu_stop, eps, sc_b, sc_c, nm_inf_b, nm_inf_c,
                    alpha, u32, v32, k0, *, T=2048, probe=8, psi=1.0,
                    woodbury=False, active=None):
    """Run the conic barrier LADDER (phase 1) for every lane: up to T f32
    DR iterations across as many barrier stages as fit, advancing
    (mu, tol_inner) through the in-kernel `adjust_barrier` tables until
    mu < mu_stop (or the T cap: re-enter with the returned state).

    Matrices `(B, ...)` f32, rows `(B, k)` f32; the scalars are floats
    or `(B,)` tensors; u32, v32 `(B, m + n + 1)`.  `active` (`(B,)`
    bool) gives inactive lanes zero iterations.  Returns
    (u, v, t_done, err, mu, tol_inner, stages), `(B, ...)` f32 and int32.
    On CPU tensors the plain version runs; on CUDA tensors the kernel."""
    B, m, n = A32.shape
    if A32.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ladder for device {A32.device}")
    op = ladder_operands(A32, Minv32, Hinv32, r_vec32, b32, c32, Qd32, D32,
                         E32, rho_y, rho_x, rho_tau, a_coef, mu, tol_inner,
                         mu_stop, eps, sc_b, sc_c, nm_inf_b, nm_inf_c, alpha,
                         u32, v32, k0)
    t_max = torch.full((B,), T, dtype=torch.int32, device=A32.device)
    if active is not None:
        t_max = torch.where(active, t_max, 0).to(torch.int32)
    run = ladder_cuda if A32.is_cuda else _dr_ladder_compute
    y, x, vy, vx, out = run(op, co, t_max, probe=probe, psi=psi,
                            woodbury=woodbury)
    u = torch.cat([y, x, out[:, 0:1]], dim=1)
    v = torch.cat([vy, vx, out[:, 1:2]], dim=1)
    return (u, v, out[:, 3].to(torch.int32), out[:, 2], out[:, 4],
            out[:, 5], out[:, 6].to(torch.int32))



# ---------------------------------------------------------------------------
# sprint: up to T iterations at one fixed barrier
# ---------------------------------------------------------------------------

# sprint scal slots, the reference's order (`conic_pallas.py:505-506`)
(C_RHOY, C_RHOX, C_RHOT, C_ACOEF, C_LAM, C_ALPHA, C_TAU, C_KAPPA, C_THRESH,
 C_K0) = range(10)
N_SPRINT_SCAL = 10
# output row: [tau, kappa, err, t_done]
SPRINT_ROW = 4


class DrSprintOperands(NamedTuple):
    """f32 operands of one sprint launch, lane axis first (the ladder's
    without D, E)."""

    scal: torch.Tensor    # (B, 10) per-lane scalars, slots C_*
    A: torch.Tensor       # (B, m, n)
    Minv: torch.Tensor    # G^-1 (B, m, m) or S^-1 (B, n, n)
    Hinv: torch.Tensor    # (B, n) Woodbury diagonal (zeros in the primal form)
    ry: torch.Tensor      # (B, m)
    rx: torch.Tensor      # (B, n)
    b: torch.Tensor       # (B, m)
    c: torch.Tensor       # (B, n)
    Qd: torch.Tensor      # (B, n)
    y: torch.Tensor       # (B, m) entry iterate
    x: torch.Tensor       # (B, n)
    vy: torch.Tensor      # (B, m)
    vx: torch.Tensor      # (B, n)


def _dr_sprint_compute(op: DrSprintOperands, co: ConeOperands, t_max, *,
                       probe, woodbury):
    """The plain PyTorch version of the sprint kernel
    (`conic_pallas._dr_sprint_compute`).

    Lane b runs trips of `probe` iterations at its fixed barrier lam
    while `t < t_max[b]` and `err >= thresh`, `err` the f32 inner
    criterion after each trip; stopped lanes are frozen by mask.
    Returns (y, x, vy, vx, row) with row `(B, 4)` =
    [tau, kappa, err, t_done], in the operands' dtype."""
    _need_ieee(op.A)
    sc = op.scal

    def col(k):
        return sc[:, k:k + 1]

    iter_body, err_inner = _make_dr_fns(
        op, co, col(C_RHOY), col(C_RHOX), col(C_RHOT), col(C_ACOEF),
        col(C_ALPHA), col(C_K0), woodbury)
    lam, thresh = col(C_LAM), col(C_THRESH)
    B, dev = op.A.shape[0], op.A.device
    t_max = t_max.to(device=dev, dtype=torch.int32).reshape(B, 1)
    state = (op.y, op.x, op.vy, op.vx, col(C_TAU), col(C_KAPPA))
    t = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    e = _full(lam, float("inf"))
    while True:
        run = (t < t_max) & (e >= thresh)
        if not bool(run.any()):
            break
        new = state
        for j in range(probe):
            new = iter_body(lam, t + j, new)
        state = tuple(torch.where(run, a, s) for a, s in zip(new, state))
        e = torch.where(run, err_inner(*new), e)
        t = torch.where(run, t + probe, t)
    y, x, vy, vx, tau, kappa = state
    return y, x, vy, vx, torch.cat([tau, kappa, e, t.to(e.dtype)], dim=1)


def dr_sprint_cuda(op: DrSprintOperands, co: ConeOperands, t_max, *, probe,
                   woodbury, plan=None):
    """The sprint on the card: one launch of `csrc/conic_sprint.cu`, one
    thread-block cluster per lane, by `dr_launch_plan`.
    Same contract as `_dr_sprint_compute`.  `plan` replaces the launch
    plan (as `ladder_cuda`'s).  Raises on an operand the kernel does not
    take, on a plan the card cannot hold and on a refused launch; never
    falls back."""
    B, m, n = op.A.shape
    dev = op.A.device
    if dev.type != "cuda":
        raise ValueError(f"dr_sprint_cuda needs CUDA tensors; got {dev}")
    if B < 1 or m < 1 or n < 1 or probe < 1:
        raise ValueError(f"empty launch: B={B} m={m} n={n} probe={probe}")
    mk = m if woodbury else n
    want = {k: (f32, (B, m if k in _LADDER_M else n))
            for k in DrSprintOperands._fields}
    want.update(scal=(f32, (B, N_SPRINT_SCAL)), A=(f32, (B, m, n)),
                Minv=(f32, (B, mk, mk)), t_max=(torch.int32, (B,)))
    t_max = t_max.to(device=dev, dtype=torch.int32).contiguous()
    check_operands(list(op._asdict().items()) + [("t_max", t_max)], want, dev)
    outs = [torch.empty((B, k), dtype=f32, device=dev)
            for k in (m, n, m, n, SPRINT_ROW)]
    launch("conic_sprint", list(op) + [t_max] + _cone_kernel_inputs(co, dev),
           outs, B, m, n, co.start.shape[0], probe, 1.0, woodbury, dev,
           SPRINT_ROW, plan)
    dr_sprint_cuda.launches += 1
    return tuple(outs)


dr_sprint_cuda.launches = 0


def dr_sprint_operands(A32, Minv32, Hinv32, r_vec32, b32, c32, Qd32, rho_y,
                       rho_x, rho_tau, a_coef, lam, alpha, thresh, u32, v32,
                       k0) -> DrSprintOperands:
    """Pack the operands of one sprint launch (`fused_dr_sprint_stop`'s
    arguments) as `DrSprintOperands`."""
    B, m, n = A32.shape
    scal = torch.stack([_per_lane(s, B, A32) for s in (
        rho_y, rho_x, rho_tau, a_coef, lam, alpha, u32[:, m + n],
        v32[:, m + n], thresh, k0)], dim=1).to(f32)

    def row(x):
        return x.to(f32).contiguous()

    return DrSprintOperands(
        scal=scal, A=A32.to(f32).contiguous(), Minv=Minv32.to(f32).contiguous(),
        Hinv=row(Hinv32), ry=row(r_vec32[:, :m]), rx=row(r_vec32[:, m:]),
        b=row(b32), c=row(c32), Qd=row(Qd32), y=row(u32[:, :m]),
        x=row(u32[:, m:m + n]), vy=row(v32[:, :m]), vx=row(v32[:, m:m + n]))


def fused_dr_sprint_stop(A32, Minv32, Hinv32, r_vec32, b32, c32, Qd32,
                         co: ConeOperands, rho_y, rho_x, rho_tau, a_coef,
                         lam, alpha, thresh, u32, v32, k0, *, T=512, probe=8,
                         woodbury=False, active=None):
    """Run up to T f32 conic DR iterations per lane in one launch,
    stopping within probe-1 iterations of the inner criterion
    `err < thresh`.

    Matrices `(B, ...)` f32: Minv32 = S^-1 `(B, n, n)` or (woodbury)
    G^-1 `(B, m, m)` with Hinv32 `(B, n)`; r_vec32 `(B, m + n)` and
    a_coef the tau-quadratic precompute; Qd32 the diagonal Q (zeros when
    absent).  Scalars are floats or `(B,)` tensors; u32, v32
    `(B, m + n + 1)`; k0 the ADMM count before this launch (the first
    iteration ever takes tau_t = 1).  `active` (`(B,)` bool) gives
    inactive lanes zero iterations.  Returns (u, v, t_done, err), f32
    and int32.  CPU tensors take the plain version; CUDA tensors the
    kernel."""
    B, m, n = A32.shape
    if A32.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sprint for device {A32.device}")
    op = dr_sprint_operands(A32, Minv32, Hinv32, r_vec32, b32, c32, Qd32,
                            rho_y, rho_x, rho_tau, a_coef, lam, alpha, thresh,
                            u32, v32, k0)
    t_max = torch.full((B,), T, dtype=torch.int32, device=A32.device)
    if active is not None:
        t_max = torch.where(active, t_max, 0).to(torch.int32)
    run = dr_sprint_cuda if A32.is_cuda else _dr_sprint_compute
    y, x, vy, vx, out = run(op, co, t_max, probe=probe, woodbury=woodbury)
    u = torch.cat([y, x, out[:, 0:1]], dim=1)
    v = torch.cat([vy, vx, out[:, 1:2]], dim=1)
    return u, v, out[:, 3].to(torch.int32), out[:, 2]



def _unpad(x, dims, dtype=np.float32):
    """A reference operand (one lane, `(1, kp)` row or `(rp, cp)`
    matrix; or batched with a leading lane axis) without its padding."""
    x = np.array(x, dtype)
    if len(dims) == 1:
        return x.reshape(-1, x.shape[-1])[:, :dims[0]]
    x = x.reshape((-1,) + x.shape[-2:])
    return x[:, :dims[0], :dims[1]]


def ladder_operands_from_numpy(args, m, n, woodbury, device=None):
    """The reference ladder's operand tuple (`fused_dr_ladder`'s
    `args`: scal_row, A, Minv, Hinv, ry, rx, b, c, Qd, D, E, the
    `ConeKernelData` fields, y, x, vy, vx; numpy, padded to 128) as the
    port's `LadderOperands`.  The cone operands come from the spec
    (`cones.cone_operands`), not from the indicator matrices."""
    args = [np.array(a) for a in args]
    tail = args[-4:]
    mk = m if woodbury else n
    vals = [_unpad(args[0], (N_LADDER_SCAL,)), _unpad(args[1], (m, n)),
            _unpad(args[2], (mk, mk))]
    for a, k in zip(args[3:11] + tail,
                    (n, m, n, m, n, n, m, n, m, n, m, n)):
        vals.append(_unpad(a, (k,)))
    return LadderOperands(*[torch.from_numpy(np.ascontiguousarray(v)).to(
        device) for v in vals])
