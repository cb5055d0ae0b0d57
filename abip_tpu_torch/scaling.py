"""Matrix equilibration of the LP path, batched over lanes.

Port of the LP part of `abip_tpu/scaling.py` (`ABIP(_normalize_A)`,
`linsys/common.c:150-565`): pc (sqrt-L1 col/row), origin (L2), Ruiz
(iterated sqrt-Linf) and qp (geometric min*max).  `A` is a `(B, m, n)`
stack; each pass is a pair of row/column reductions and a rescale.

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
