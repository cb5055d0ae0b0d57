"""Matrix equilibration of the LP and conic paths, batched over lanes.

Port of `abip_tpu/scaling.py`: the LP pipeline (`ABIP(_normalize_A)`,
`linsys/common.c:150-565`: pc (sqrt-L1 col/row), origin (L2), Ruiz
(iterated sqrt-Linf) and qp (geometric min*max)) and the cone-tied conic
equilibration (`equilibrate_conic`, `qcp_config.c:91-491`).  `A` is a
`(B, m, n)` stack; each pass is a pair of row/column reductions and a
rescale.  The sparse host variant is not ported yet.

D and E accumulate all applied row/column scalings so that
A_scaled = diag(1/D) @ A @ diag(1/E) * scale.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MIN_SCALE = 1e-3
MAX_SCALE = 1e3

# The factor loops run in f32 at and above this many elements per lane
# (the full-matrix passes are the cost there) and in the input dtype
# below it, where ppm-level factor noise can flip marginal small
# instances across a stability edge.  Same threshold as the reference
# package, so both take the same branch on the same shape.
_F32_SCALING_MIN_ELEMS = 1 << 18


class ScalingData(NamedTuple):
    D: torch.Tensor              # row scalings (B, m)
    E: torch.Tensor              # column scalings (B, n)
    mean_norm_row: torch.Tensor  # (B,) mean row 2-norm of the scaled A
    mean_norm_col: torch.Tensor  # (B,) mean col 2-norm of the scaled A


def _factor_dtype(A):
    m, n = A.shape[-2:]
    return torch.float32 if m * n >= _F32_SCALING_MIN_ELEMS else A.dtype


def _clip_col(e, n_rows):
    """Column-scale guard (`common.c:224-229`): tiny -> 1, huge -> cap."""
    root = torch.sqrt(torch.tensor(float(n_rows), dtype=e.dtype,
                                   device=e.device))
    lo = MIN_SCALE * root
    hi = MAX_SCALE * root
    return torch.where(e < lo, torch.ones_like(e), torch.minimum(e, hi))


def _pc_pass(A):
    """sqrt-L1 column then row scaling (`common.c:217-266`)."""
    m, n = A.shape[-2:]
    E = _clip_col(torch.sqrt(A.abs().sum(-2)), m)
    A = A / E[:, None, :]
    D = _clip_col(torch.sqrt(A.abs().sum(-1)), n)
    A = A / D[:, :, None]
    return A, D, E


def _origin_pass(A):
    """L2 column then row scaling (`common.c:279-327`)."""
    m, n = A.shape[-2:]
    E = _clip_col(torch.linalg.vector_norm(A, dim=-2), m)
    A = A / E[:, None, :]
    D = _clip_col(torch.linalg.vector_norm(A, dim=-1), n)
    A = A / D[:, :, None]
    return A, D, E


def _ruiz_pass(A, iters):
    """Iterated sqrt-Linf scaling (`common.c:339-413`)."""
    B, m, n = A.shape
    D = torch.ones((B, m), dtype=A.dtype, device=A.device)
    E = torch.ones((B, n), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        Et = _clip_col(torch.sqrt(A.abs().amax(-2)), m)
        A = A / Et[:, None, :]
        Dt = _clip_col(torch.sqrt(A.abs().amax(-1)), n)
        A = A / Dt[:, :, None]
        D, E = D * Dt, E * Et
    return A, D, E


def _minmax_scale(absA, dim):
    """sqrt(min * max) of the nonzero magnitudes along `dim`; 0 where
    the row or column is all zeros."""
    big = torch.where(absA > 0, absA, -torch.inf)
    small = torch.where(absA > 0, absA, torch.inf)
    hi = big.amax(dim)
    lo = small.amin(dim)
    return torch.sqrt(torch.where(torch.isfinite(hi), lo * hi,
                                  torch.zeros_like(hi)))


def _qp_pass(A):
    """Geometric-mean (min*max of |nonzeros|) scaling (`common.c:415-509`)."""
    m, n = A.shape[-2:]
    E = _clip_col(_minmax_scale(A.abs(), -2), m)
    A = A / E[:, None, :]
    D = _clip_col(_minmax_scale(A.abs(), -1), n)
    A = A / D[:, :, None]
    return A, D, E


def normalize_bc(scal: ScalingData, b, c, scale):
    """b/c normalization after equilibration (`normalize.c:11-40`):
    scale each vector by the equilibration diagonals, then by
    mean-norm / max(||.||, 1e-3), then by the global `scale`.
    Returns (b_s, c_s, sc_b, sc_c) with per-lane `(B,)` factors."""
    c_s = c / scal.E
    sc_c = scal.mean_norm_row / torch.linalg.vector_norm(
        c_s, dim=-1).clamp_min(1e-3)
    b_s = b / scal.D
    sc_b = scal.mean_norm_col / torch.linalg.vector_norm(
        b_s, dim=-1).clamp_min(1e-3)
    return (b_s * sc_b[:, None] * scale, c_s * sc_c[:, None] * scale,
            sc_b, sc_c)


def equilibrate(A, settings) -> tuple[torch.Tensor, ScalingData]:
    """Full pipeline (`common.c:150-565`): pc -> origin -> ruiz -> qp.

    Returns the scaled `(B, m, n)` matrix (including the global `scale`
    factor) and the accumulated D/E plus the mean row/col norms used by
    b/c normalization.  The factors are accumulated in `_factor_dtype`
    and applied once to `A` in its own dtype."""
    B, m, n = A.shape
    fdt = _factor_dtype(A)
    A_it = A.to(fdt)
    D = torch.ones((B, m), dtype=fdt, device=A.device)
    E = torch.ones((B, n), dtype=fdt, device=A.device)

    if settings.pc_ruiz_rescale:
        A_it, Dp, Ep = _pc_pass(A_it)
        D, E = D * Dp, E * Ep
    if settings.origin_rescale:
        A_it, Do, Eo = _origin_pass(A_it)
        D, E = D * Do, E * Eo
    if settings.pc_ruiz_rescale:
        A_it, Dr, Er = _ruiz_pass(A_it, settings.ruiz_iter)
        D, E = D * Dr, E * Er
    if settings.qp_rescale:
        A_it, Dq, Eq = _qp_pass(A_it)
        D, E = D * Dq, E * Eq

    D = D.to(A.dtype)
    E = E.to(A.dtype)
    A = A / E[:, None, :] / D[:, :, None]

    mean_norm_row = torch.linalg.vector_norm(A, dim=-1).mean(-1)
    mean_norm_col = torch.linalg.vector_norm(A, dim=-2).mean(-1)

    if settings.scale != 1:
        A = A * settings.scale

    return A, ScalingData(D=D, E=E, mean_norm_row=mean_norm_row,
                          mean_norm_col=mean_norm_col)


class ConicScalingData(NamedTuple):
    D: torch.Tensor      # (B, m)
    E: torch.Tensor      # (B, n)
    sc_b: torch.Tensor   # (B,)
    sc_c: torch.Tensor   # (B,)


def _clip_keep(v, n_other):
    """Conic variant of the scale guard (`qcp_config.c:220-232`)."""
    root = torch.sqrt(torch.tensor(float(n_other), dtype=v.dtype,
                                   device=v.device))
    return torch.where(v < MIN_SCALE * root, torch.ones_like(v),
                       torch.minimum(v, MAX_SCALE * root))


def equilibrate_conic(A, Q, b, c, layout, settings):
    """Conic equilibration (`scaling_qcp_data`, `qcp_config.c:91-491`),
    port of `abip_tpu/scaling.py:134-225` for a `(B, m, n)` stack.

    Column scalings come from A and the diagonal Q `(B, n)` (elementwise
    max), tied to a common value within each SOC/RSOC block, then
    applied as A <- D^-1 A E^-1, Q <- E^-1 Q E^-1.  Order: ruiz (10
    iterations) -> origin -> pc, then b/c scaling with
    sc = (||b||^2 + ||c||^2)^(1/4) of the ORIGINAL data.  The factor
    loop runs in f32 at and above `_F32_SCALING_MIN_ELEMS` elements per
    lane, as in the reference, and the factors are applied once to the
    data in its own dtype.  A full (2-D per lane) Q is not ported."""
    B, m, n = A.shape
    if Q is not None and Q.dim() != 2:
        raise NotImplementedError(
            "a full (n, n) Q is not ported to abip_tpu_torch yet "
            "(ROADMAP.md queue 1, item 11)")
    dtype = A.dtype

    # sc from the un-equilibrated b, c (`qcp_config.c:462-463`)
    sc = torch.sqrt(torch.sqrt((c * c).sum(-1) + (b * b).sum(-1)))
    sc = torch.where(sc < MIN_SCALE, torch.ones_like(sc),
                     torch.clamp(sc, max=MAX_SCALE))
    sc_b = 1.0 / sc
    sc_c = 1.0 / sc

    def col_metric(A, Q, kind):
        if kind == "inf":
            e1 = torch.sqrt(A.abs().amax(-2))
        elif kind == "l2":
            e1 = torch.sqrt(torch.linalg.vector_norm(A, dim=-2))
        else:  # l1
            e1 = torch.sqrt(A.abs().sum(-2))
        if Q is None:
            return e1
        # any column reduction of a diagonal matrix is |q_j|
        return torch.maximum(e1, torch.sqrt(Q.abs()))

    def row_metric(A, kind):
        if kind == "inf":
            return torch.sqrt(A.abs().amax(-1))
        if kind == "l2":
            return torch.sqrt(torch.sqrt((A * A).sum(-1)))
        return torch.sqrt(A.abs().sum(-1))

    def one_pass(A, Q, D_hat, E_hat, kind):
        E = _clip_keep(layout.segment_mean_tie(col_metric(A, Q, kind)), m)
        D = _clip_keep(row_metric(A, kind), n)
        A = A / E[:, None, :] / D[:, :, None]
        if Q is not None:
            Q = Q / (E * E)
        return A, Q, D_hat * D, E_hat * E

    fdt = _factor_dtype(A)
    A_it = A.to(fdt)
    Q_it = None if Q is None else Q.to(fdt)
    D_f = torch.ones((B, m), dtype=fdt, device=A.device)
    E_f = torch.ones((B, n), dtype=fdt, device=A.device)
    if settings.pc_ruiz_rescale:  # ruiz_scaling in the conic reference
        for _ in range(settings.ruiz_iter):
            A_it, Q_it, D_f, E_f = one_pass(A_it, Q_it, D_f, E_f, "inf")
    if settings.origin_rescale:
        A_it, Q_it, D_f, E_f = one_pass(A_it, Q_it, D_f, E_f, "l2")
    if settings.qp_rescale:  # pc_scaling slot in the conic reference
        A_it, Q_it, D_f, E_f = one_pass(A_it, Q_it, D_f, E_f, "l1")
    D_hat = D_f.to(dtype)
    E_hat = E_f.to(dtype)
    A = A / E_hat[:, None, :] / D_hat[:, :, None]
    if Q is not None:
        Q = Q / (E_hat * E_hat)

    b = b / D_hat * (sc_b * settings.scale)[:, None]
    c = c / E_hat * (sc_c * settings.scale)[:, None]
    return A, Q, b, c, ConicScalingData(D=D_hat, E=E_hat, sc_b=sc_b,
                                        sc_c=sc_c)
