"""Differentiable solution maps: implicit differentiation through the solver.

Port of `abip_tpu/diff.py`.  The solution map
``(A, b, c[, Q]) -> (x, y, s)`` of

    min  1/2 x'Qx + c'x   s.t.  Ax = b,  x in K

is a `torch.autograd.Function`: the forward is the port's whole-solve
driver (`device_solve_lp`, `solve_qcp_device`), and the backward never
differentiates through the ADMM iterations; it applies the implicit
function theorem to the KKT residual map at the returned solution (the
role diffcp plays for SCS).  With z := x - s and Pi the projection onto
K (x = Pi(z), s = Pi(z) - z), the vector-Jacobian product solves the
(n+m) x (n+m) adjoint system

    [ P A'   P Q - P + I ] [w1]   [ P (gx + gs) - gs ]
    [  0         -A      ] [w2] = [        gy        ]

with P = D Pi(z) (`dprojection_dense`, block-diagonal), then reads off

    grad_A = -w1 x' + y w2',   grad_b = w1,   grad_c = -w2,
    grad_Q_diag = -(w2 * x).

`lstsq=True` solves it in the minimum-norm least-squares sense through
an SVD (the reference's `jnp.linalg.lstsq`, with its cut-off): at kinks
and degenerate vertices, where the system is singular, that returns the
minimum-norm heuristic gradient.  (`torch.linalg.lstsq` on CUDA offers
only a full-rank QR driver, which returns no such gradient.)
`lstsq=False` is a plain LU solve.  Gradients of instances that were not
Solved are NaN on purpose.
"""
from __future__ import annotations

import numpy as np
import torch

from .cones import _FREE, _NONNEG, ConeLayout, ConeSpec
from .device import resolve_device

__all__ = ["solve_lp_grad", "solve_qcp_grad", "solve_lasso_grad",
           "solve_svm_grad", "dprojection_dense"]

_TINY = 1e-30
f64 = torch.float64


# --------------------------------------------------------------------- #
# derivative of the cone projection                                     #
# --------------------------------------------------------------------- #
def _dpi_soc_block(zb):
    """D Pi_SOC at zb = (t, u): I inside (||u|| <= t), 0 in the polar
    cone (||u|| <= -t), else
        0.5 * [[1, ub'], [ub, (1 + t/nu) I - (t/nu) ub ub']],
    ub = u/||u||."""
    d = zb.shape[0]
    t, u = zb[0], zb[1:]
    nu = torch.linalg.vector_norm(u)
    nu_safe = torch.clamp(nu, min=_TINY)
    ub = u / nu_safe
    r = t / nu_safe
    Bm = torch.zeros((d, d), dtype=zb.dtype, device=zb.device)
    Bm[0, 0] = 0.5
    Bm[0, 1:] = 0.5 * ub
    Bm[1:, 0] = 0.5 * ub
    Bm[1:, 1:] = 0.5 * ((1.0 + r) * torch.eye(d - 1, dtype=zb.dtype,
                                              device=zb.device)
                        - r * torch.outer(ub, ub))
    eye = torch.eye(d, dtype=zb.dtype, device=zb.device)
    return torch.where(nu <= t, eye,
                       torch.where(nu <= -t, torch.zeros_like(eye), Bm))


def _rsoc_rotation(d, dtype, device):
    """Orthogonal H with RSOC = H(SOC): (a, b, w) -> ((a+b)/sqrt2,
    (a-b)/sqrt2, w).  H is symmetric, H @ H = I."""
    H = np.eye(d)
    H[0, 0] = H[0, 1] = H[1, 0] = 1.0 / np.sqrt(2.0)
    H[1, 1] = -1.0 / np.sqrt(2.0)
    return torch.as_tensor(H, dtype=dtype, device=device)


def dprojection_dense(z: torch.Tensor, layout: ConeLayout) -> torch.Tensor:
    """D Pi_K(z) as a dense (n, n) matrix (block-diagonal per cone):
    free 1, zero 0, nonneg z > 0 on the diagonal; SOC blocks by
    `_dpi_soc_block`; RSOC blocks H P_SOC(H z) H."""
    kind = torch.as_tensor(layout.kind, device=z.device)
    diag = torch.where(kind == _NONNEG, (z > 0).to(z.dtype),
                       torch.zeros_like(z))
    diag = torch.where(kind == _FREE, torch.ones_like(z), diag)
    P = torch.diag(diag)
    pos = 0
    for q in layout.spec.soc:
        if q > 1:  # a 1-d SOC is a nonneg element of the layout
            P[pos:pos + q, pos:pos + q] = _dpi_soc_block(z[pos:pos + q])
        pos += q
    for q in layout.spec.rsoc:
        H = _rsoc_rotation(q, z.dtype, z.device)
        Pb = _dpi_soc_block(H @ z[pos:pos + q])
        P[pos:pos + q, pos:pos + q] = H @ Pb @ H
        pos += q
    return P


# --------------------------------------------------------------------- #
# adjoint system                                                        #
# --------------------------------------------------------------------- #
def _min_norm_solve(M, rhs):
    """The minimum-norm least-squares solution of M w = rhs by SVD, with
    the reference's cut-off: singular values below eps * max(M.shape)
    times the largest count as zero (`jnp.linalg.lstsq`)."""
    # on the card the Jacobi SVD (cuSOLVER gesvdj): the default QR-based
    # one takes seconds at the smoke LP's n + m = 2050
    U, S, Vh = torch.linalg.svd(M, full_matrices=False,
                                driver="gesvdj" if M.is_cuda else None)
    rcond = torch.finfo(M.dtype).eps * max(M.shape)
    keep = S >= rcond * S[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                        torch.zeros_like(S))
    return Vh.transpose(-1, -2) @ (s_inv * (U.transpose(-1, -2) @ rhs))


def _implicit_vjp(A, x, y, s, q, layout, gx, gy, gs, lstsq):
    """Solve the adjoint KKT system at one solution and assemble the
    parameter gradients (`diff.py:123-159`)."""
    m, n = A.shape
    z = x - s
    P = dprojection_dense(z, layout)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    PQ = P * q[None, :] if q is not None else torch.zeros_like(P)
    top = torch.cat([P @ A.T, PQ - P + eye], dim=1)
    bot = torch.cat([torch.zeros((m, m), dtype=A.dtype, device=A.device),
                     -A], dim=1)
    M = torch.cat([top, bot], dim=0)
    rhs = torch.cat([P @ (gx + gs) - gs, gy])
    w = _min_norm_solve(M, rhs) if lstsq else torch.linalg.solve(M, rhs)
    w1, w2 = w[:m], w[m:]
    gA = -torch.outer(w1, x) + torch.outer(y, w2)
    gq = -(w2 * x) if q is not None else None
    return gA, w1, -w2, gq


def _gate(solved, *grads):
    """NaN-poison the gradients of an unsolved instance."""
    return tuple(None if g is None else
                 torch.where(solved, g, torch.full_like(g, float("nan")))
                 for g in grads)


# --------------------------------------------------------------------- #
# LP solution map                                                       #
# --------------------------------------------------------------------- #
class _LPSolution(torch.autograd.Function):
    """(A, b, c) -> (x, y, s, status) for a `(B, ...)` stack: one
    batched forward (`device_solve_lp`), the adjoint solve per lane."""

    @staticmethod
    def forward(ctx, A, b, c, opts, lstsq):
        from .parallel.batched import device_solve_lp

        r = device_solve_lp(A, b, c, **dict(opts))
        ctx.save_for_backward(A, r.x, r.y, r.s, r.status)
        ctx.lstsq = lstsq
        ctx.mark_non_differentiable(r.status)
        return r.x, r.y, r.s, r.status

    @staticmethod
    def backward(ctx, gx, gy, gs, _gstatus):
        A, x, y, s, status = ctx.saved_tensors
        layout = ConeLayout(ConeSpec.lp(A.shape[-1]))
        # a lane with no cotangent has zero gradients (w = M^+ 0 = 0):
        # its adjoint solve is skipped
        live = ((gx != 0).any(-1) | (gy != 0).any(-1)
                | (gs != 0).any(-1)).tolist()
        grads = []
        for k in range(A.shape[0]):
            if live[k]:
                g = _implicit_vjp(A[k], x[k], y[k], s[k], None, layout,
                                  gx[k], gy[k], gs[k], ctx.lstsq)[:3]
            else:
                g = (torch.zeros_like(A[k]), torch.zeros_like(y[k]),
                     torch.zeros_like(x[k]))
            grads.append(_gate(status[k] == 1, *g))
        gA, gb, gc = (torch.stack(f) for f in zip(*grads))
        return gA, gb, gc, None, None


def _as_f64(x, dev):
    """`x` as an f64 tensor on `dev`, differentiably for a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=f64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)


def solve_lp_grad(A, b, c, *, eps=1e-8, lstsq=True, device=None, **kw):
    """Differentiable LP solution map on `device` (default: the CUDA
    card): returns ``(x, y, s)``.

    Gradients of any function of the returned triple reach (A, b, c) by
    the implicit function theorem at the solution, not by unrolling the
    ADMM iterations.  A leading batch axis on any of A `(B, m, n)`, b
    `(B, m)` or c `(B, n)` (the others broadcast) solves the B instances
    in one batched forward, with the adjoint solve per lane; each lane
    equals its own call.  eps defaults tighter (1e-8) than the solver's
    default: the gradient inherits the forward's accuracy.  `kw` are
    `device_solve_lp`'s options."""
    dev = resolve_device(device)
    A, b, c = (_as_f64(v, dev) for v in (A, b, c))
    batched = A.dim() == 3 or b.dim() == 2 or c.dim() == 2
    if batched:
        B = max(v.shape[0] for v, d in ((A, 3), (b, 2), (c, 2))
                if v.dim() == d)
        A = A.expand((B,) + A.shape[-2:])
        b = b.expand(B, b.shape[-1])
        c = c.expand(B, c.shape[-1])
    else:
        A, b, c = A[None], b[None], c[None]
    opts = tuple(sorted({"eps": eps, **kw}.items()))
    x, y, s, _ = _LPSolution.apply(A, b, c, opts, bool(lstsq))
    return (x, y, s) if batched else (x[0], y[0], s[0])


# --------------------------------------------------------------------- #
# conic / QCP solution map                                              #
# --------------------------------------------------------------------- #
class _QCPSolution(torch.autograd.Function):
    """(A, b, c, q) -> (x, y, s, status) for one instance
    (`solve_qcp_device`)."""

    @staticmethod
    def forward(ctx, A, b, c, q, spec, opts, lstsq):
        from .parallel.batched_qcp import solve_qcp_device

        r = solve_qcp_device(A, b, c, q, cones=spec, device=A.device,
                             **dict(opts))
        ctx.save_for_backward(A, q, r.x, r.y, r.s, r.status)
        ctx.spec, ctx.lstsq, ctx.has_q = spec, lstsq, q is not None
        ctx.mark_non_differentiable(r.status)
        return r.x, r.y, r.s, r.status

    @staticmethod
    def backward(ctx, gx, gy, gs, _gstatus):
        A, q, x, y, s, status = ctx.saved_tensors
        qq = q if ctx.has_q else torch.zeros_like(x)
        gA, gb, gc, gq = _implicit_vjp(A, x, y, s, qq, ConeLayout(ctx.spec),
                                       gx, gy, gs, ctx.lstsq)
        gA, gb, gc, gq = _gate(status == 1, gA, gb, gc, gq)
        return gA, gb, gc, (gq if ctx.has_q else None), None, None, None


def solve_qcp_grad(A, b, c, *, cones: ConeSpec, Q_diag=None, eps=1e-8,
                   lstsq=True, device=None, **kw):
    """Differentiable conic/QP solution map on `device` (default: the
    CUDA card): returns ``(x, y, s)`` for

        min 1/2 x'diag(Q_diag)x + c'x   s.t.  Ax = b,  x in K.

    The forward is `solve_qcp_device` (its options in `kw`); see the
    module docstring for the backward and its caveats."""
    dev = resolve_device(device)
    A, b, c = (_as_f64(v, dev) for v in (A, b, c))
    q = None if Q_diag is None else _as_f64(Q_diag, dev)
    opts = tuple(sorted({"eps": eps, **kw}.items()))
    x, y, s, _ = _QCPSolution.apply(A, b, c, q, cones, opts, bool(lstsq))
    return x, y, s


def solve_lasso_grad(X, y, lam, *, eps=1e-8, lstsq=True, device=None, **kw):
    """Differentiable LASSO: w*(X, y, lam) for

        min_w  1/2 ||Xw - y||^2 + lam ||w||_1,

    through the reference's conic embedding (`problems/lasso.py`,
    `source/lasso_config.c:8-93`), built from tensors so that gradients
    reach X, y and the scalar lam."""
    dev = resolve_device(device)
    X, y, lam = (_as_f64(v, dev) for v in (X, y, lam))
    m, n = X.shape
    z = dict(dtype=f64, device=dev)
    top = torch.cat([torch.ones((1, 1), **z),
                     torch.zeros((1, 1 + m + 2 * n), **z)], dim=1)
    rows = torch.cat([torch.zeros((m, 2), **z), torch.eye(m, **z), X, -X],
                     dim=1)
    A = torch.cat([top, rows], dim=0)
    b = torch.cat([torch.ones((1,), **z), y])
    c = torch.cat([torch.zeros((1,), **z), torch.ones((1,), **z),
                   torch.zeros((m,), **z), lam * torch.ones((2 * n,), **z)])
    x, _, _ = solve_qcp_grad(A, b, c, cones=ConeSpec(rsoc=(2 + m,),
                                                     nonneg=2 * n),
                             eps=eps, lstsq=lstsq, device=dev, **kw)
    return x[2 + m:2 + m + n] - x[2 + m + n:]


def solve_svm_grad(X, y, C, *, eps=1e-8, lstsq=True, device=None, **kw):
    """Differentiable hinge-loss SVM: (w*, b0*)(X, y, C) for

        min_{w, b0}  1/2 ||w||^2 + C sum_i max(0, 1 - y_i (x_i'w + b0)),

    through the reference's QP embedding (`problems/svm.py
    svm_to_conic_qp`, `source/svm_qp_config.c:8-60`), built from
    tensors: gradients reach X and the scalar C."""
    dev = resolve_device(device)
    X, y, C = (_as_f64(v, dev) for v in (X, y, C))
    m, n = X.shape
    z = dict(dtype=f64, device=dev)
    eye = torch.eye(m, **z)
    A = torch.cat([y[:, None] * X, y[:, None], eye, -eye], dim=1)
    b = torch.ones((m,), **z)
    c = torch.cat([torch.zeros((n + 1,), **z), C * torch.ones((m,), **z),
                   torch.zeros((m,), **z)])
    q_diag = torch.cat([torch.ones((n,), **z), torch.zeros((1 + 2 * m,), **z)])
    x, _, _ = solve_qcp_grad(A, b, c, cones=ConeSpec(free=n + 1,
                                                     nonneg=2 * m),
                             Q_diag=q_diag, eps=eps, lstsq=lstsq, device=dev,
                             **kw)
    return x[:n], x[n]
