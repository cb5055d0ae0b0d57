"""The plain reference: a primal-dual interior-point method and the judge.

Plain PyTorch, independent of the program under test: it imports
nothing of it and takes nothing it made.  Problems are in the program's
standard form, min c'x s.t. Ax = b, x in K, with the dual
max b'y s.t. A'y + s = c, s in K*; K is a product of second-order cones,
rotated second-order cones and the nonnegative orthant, in the block
order {"soc": [...], "rsoc": [...], "nonneg": k} (an LP is
{"nonneg": n}).  Every cone here is self-dual.

`solve` is Mehrotra's predictor-corrector method with Nesterov-Todd
scaling on a batch of same-shape instances, in the dtype of its inputs:
in float64 it gives each instance's optimum to about 1e-9; run in
float32, in the program's place, it is the benchmark's control.  A
rotated cone {2 t1 t2 >= ||z||^2} is the image of a second-order cone
under the orthogonal, symmetric map T that sends (t1, t2) to
((t1 + t2)/sqrt 2, (t1 - t2)/sqrt 2), so the method works on A T, T c
and maps x and s back by T.

`judge` measures answers in float64 against the instance data and the
reference's optimum.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

SQRT_HALF = math.sqrt(0.5)


class Blocks(NamedTuple):
    """(offset, size) of every second-order block, rotated ones after the
    plain ones; the rotated ones also listed alone; the orthant's
    offset and size."""

    soc: list
    rsoc: list
    lin: tuple


def blocks(cones: dict) -> Blocks:
    for key in cones:
        if key not in ("soc", "rsoc", "nonneg"):
            raise ValueError(f"the reference takes soc, rsoc and nonneg "
                             f"cones; got {key!r}")
    soc, rsoc, off = [], [], 0
    for d in cones.get("soc", ()):
        soc.append((off, d))
        off += d
    for d in cones.get("rsoc", ()):
        soc.append((off, d))
        rsoc.append((off, d))
        off += d
    return Blocks(soc, rsoc, (off, cones.get("nonneg", 0)))


def rsoc_map(v, bl: Blocks):
    """T applied along the last axis (T is its own inverse)."""
    if not bl.rsoc:
        return v
    out = v.clone()
    for off, _ in bl.rsoc:
        a, b = v[..., off], v[..., off + 1]
        out[..., off] = (a + b) * SQRT_HALF
        out[..., off + 1] = (a - b) * SQRT_HALF
    return out


def _soc_det(x):
    return x[..., 0] ** 2 - (x[..., 1:] ** 2).sum(-1)


def _jordan(u, w, bl):
    """u o w, blockwise."""
    out = torch.empty_like(u)
    for off, d in bl.soc:
        a, b = u[:, off:off + d], w[:, off:off + d]
        out[:, off] = (a * b).sum(-1)
        out[:, off + 1:off + d] = a[:, :1] * b[:, 1:] + b[:, :1] * a[:, 1:]
    lo, k = bl.lin
    out[:, lo:lo + k] = u[:, lo:lo + k] * w[:, lo:lo + k]
    return out


def _jordan_solve(lam, r, bl):
    """z with lam o z = r, blockwise."""
    z = torch.empty_like(r)
    for off, d in bl.soc:
        l0, l1 = lam[:, off], lam[:, off + 1:off + d]
        r0, r1 = r[:, off], r[:, off + 1:off + d]
        z0 = (l0 * r0 - (l1 * r1).sum(-1)) / _soc_det(lam[:, off:off + d])
        z[:, off] = z0
        z[:, off + 1:off + d] = (r1 - z0[:, None] * l1) / l0[:, None]
    lo, k = bl.lin
    z[:, lo:lo + k] = r[:, lo:lo + k] / lam[:, lo:lo + k]
    return z


def _identity(x, bl):
    e = torch.zeros_like(x)
    for off, _ in bl.soc:
        e[:, off] = 1.0
    lo, k = bl.lin
    e[:, lo:lo + k] = 1.0
    return e


class _Scaling(NamedTuple):
    """Nesterov-Todd scaling W (W x = W^-1 s = lam), blockwise: for each
    second-order block eta and v (W = eta (2 v v' - J)), for the orthant
    the diagonal sqrt(s / x)."""

    eta: list
    v: list
    d: torch.Tensor


def _nt(x, s, bl) -> _Scaling:
    etas, vs = [], []
    for off, d in bl.soc:
        xb, sb = x[:, off:off + d], s[:, off:off + d]
        dx, ds = _soc_det(xb), _soc_det(sb)
        xbar = xb / dx.sqrt()[:, None]
        sbar = sb / ds.sqrt()[:, None]
        jx = xbar.clone()
        jx[:, 1:] = -jx[:, 1:]
        # the scaling point w (w'Jw = 1), then v = (w + e)/sqrt(2(w_0 + 1))
        w = (sbar + jx) / (2.0 * (1.0 + (xbar * sbar).sum(-1))).sqrt()[:, None]
        v = w.clone()
        v[:, 0] += 1.0
        vs.append(v / (2.0 * (w[:, 0] + 1.0)).sqrt()[:, None])
        etas.append((ds / dx) ** 0.25)
    lo, k = bl.lin
    return _Scaling(etas, vs, (s[:, lo:lo + k] / x[:, lo:lo + k]).sqrt())


def _apply_w(W, u, bl, inverse=False):
    """W u, or W^-1 u."""
    out = torch.empty_like(u)
    for (off, d), eta, v in zip(bl.soc, W.eta, W.v):
        ub = u[:, off:off + d]
        ju = ub.clone()
        ju[:, 1:] = -ju[:, 1:]
        if inverse:       # (1/eta)(2 J v v'J - J) u
            jv = v.clone()
            jv[:, 1:] = -jv[:, 1:]
            out[:, off:off + d] = (2.0 * jv * (jv * ub).sum(-1, keepdim=True)
                                   - ju) / eta[:, None]
        else:             # eta (2 v v' - J) u
            out[:, off:off + d] = eta[:, None] * (
                2.0 * v * (v * ub).sum(-1, keepdim=True) - ju)
    lo, k = bl.lin
    out[:, lo:lo + k] = (u[:, lo:lo + k] / W.d if inverse
                         else u[:, lo:lo + k] * W.d)
    return out


def _normal_matrix(A, W, bl):
    """A W^-2 A', (B, m, m)."""
    lo, k = bl.lin
    Al = A[:, :, lo:lo + k] / W.d[:, None, :]
    M = Al @ Al.transpose(1, 2)
    for (off, d), eta, v in zip(bl.soc, W.eta, W.v):
        Ab = A[:, :, off:off + d]
        jv = v.clone()
        jv[:, 1:] = -jv[:, 1:]
        # W^-1 = (1/eta)(2 jv jv' - J): A_b W^-1 is a rank-one update of A_b J
        AJ = Ab.clone()
        AJ[:, :, 1:] = -AJ[:, :, 1:]
        AW = (2.0 * (Ab @ jv[:, :, None]) * jv[:, None, :] - AJ) \
            / eta[:, None, None]
        M = M + AW @ AW.transpose(1, 2)
    return M


def _max_step(x, dx, bl):
    """Largest alpha (up to 1e30) with x + alpha dx in K, per lane."""
    big = torch.full(x.shape[:1], 1e30, dtype=x.dtype, device=x.device)
    alpha = big
    for off, d in bl.soc:
        xb, db = x[:, off:off + d], dx[:, off:off + d]
        a = _soc_det(db)
        b = xb[:, 0] * db[:, 0] - (xb[:, 1:] * db[:, 1:]).sum(-1)
        c = _soc_det(xb)
        disc = (b * b - a * c).clamp(min=0.0)
        hits = (a < 0) | ((b < 0) & (b * b >= a * c))
        root = c / (-b + disc.sqrt())
        alpha = torch.minimum(alpha, torch.where(hits, root, big))
    lo, k = bl.lin
    xl, dl = x[:, lo:lo + k], dx[:, lo:lo + k]
    ratio = torch.where(dl < 0, -xl / dl, torch.full_like(xl, 1e30))
    if k:
        alpha = torch.minimum(alpha, ratio.min(-1).values)
    return alpha


class Answer(NamedTuple):
    x: torch.Tensor          # (B, n)
    y: torch.Tensor          # (B, m)
    s: torch.Tensor          # (B, n)
    status: torch.Tensor     # (B,) int: 1 met eps, 0 did not
    iters: torch.Tensor      # (B,) int


def _rel(A, b, c, x, y, s):
    """(primal, dual, gap) relative residuals, inf-norms, per lane."""
    inf = lambda v: v.abs().amax(-1)  # noqa: E731
    rp = inf((A @ x[..., None])[..., 0] - b) / (1.0 + inf(b))
    rd = inf((A.transpose(1, 2) @ y[..., None])[..., 0] + s - c) \
        / (1.0 + inf(c))
    cx, by = (c * x).sum(-1), (b * y).sum(-1)
    return rp, rd, (cx - by).abs() / (1.0 + cx.abs() + by.abs())


def solve(A, b, c, cones: dict, eps: float, max_iter: int = 100) -> Answer:
    """Solve each lane of (B, m, n) A, (B, m) b, (B, n) c to relative
    residuals and gap below `eps`, in the dtype of A.  A lane stops when
    it meets eps, when its step or its normal matrix fails, or after
    `max_iter` iterations, and keeps its last iterate."""
    bl = blocks(cones)
    At, ct = rsoc_map(A, bl), rsoc_map(c, bl)
    B, m, n = A.shape
    x = _identity(ct, bl)
    s = x.clone()
    y = torch.zeros_like(b)
    nu = len(bl.soc) + bl.lin[1]
    active = torch.ones(B, dtype=torch.bool, device=A.device)
    met = torch.zeros(B, dtype=torch.bool, device=A.device)
    iters = torch.zeros(B, dtype=torch.int64, device=A.device)
    AtT = At.transpose(1, 2)
    for _ in range(max_iter):
        rp_n, rd_n, gap = _rel(At, b, ct, x, y, s)
        done = (rp_n < eps) & (rd_n < eps) & (gap < eps)
        met |= active & done
        active &= ~done
        if not bool(active.any()):
            break
        rp = b - (At @ x[..., None])[..., 0]
        rd = ct - (AtT @ y[..., None])[..., 0] - s
        W = _nt(x, s, bl)
        lam = _apply_w(W, x, bl)
        L, info = torch.linalg.cholesky_ex(_normal_matrix(At, W, bl))
        active &= info == 0
        ok = active[:, None]

        def newton(z):
            w2rd = _apply_w(W, _apply_w(W, rd, bl, True), bl, True)
            rhs = rp - (At @ (_apply_w(W, z, bl, True) - w2rd)[..., None])[..., 0]
            dy = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            aty = (AtT @ dy[..., None])[..., 0]
            dx = _apply_w(W, _apply_w(W, aty - rd, bl, True), bl, True) \
                + _apply_w(W, z, bl, True)
            return dx, dy, rd - aty

        mu = (x * s).sum(-1) / nu
        lam2 = _jordan(lam, lam, bl)
        dxa, _, dsa = newton(-lam)
        aa = torch.minimum(_max_step(x, dxa, bl), _max_step(s, dsa, bl)) \
            .clamp(max=1.0)
        mua = ((x + aa[:, None] * dxa) * (s + aa[:, None] * dsa)).sum(-1) / nu
        sigma = (mua / mu).clamp(min=0.0, max=1.0) ** 3
        rc = -lam2 - _jordan(_apply_w(W, dxa, bl), _apply_w(W, dsa, bl, True),
                             bl) + (sigma * mu)[:, None] * _identity(x, bl)
        dx, dy, ds = newton(_jordan_solve(lam, rc, bl))
        alpha = (0.99 * torch.minimum(_max_step(x, dx, bl),
                                      _max_step(s, ds, bl))).clamp(max=1.0)
        good = ok & torch.isfinite(dx).all(-1, keepdim=True) \
            & torch.isfinite(ds).all(-1, keepdim=True) \
            & torch.isfinite(dy).all(-1, keepdim=True)
        a = alpha[:, None]
        x = torch.where(good, x + a * dx, x)
        s = torch.where(good, s + a * ds, s)
        y = torch.where(good, y + a * dy, y)
        iters += good[:, 0].long()
        active &= good[:, 0]
    return Answer(rsoc_map(x, bl), y, rsoc_map(s, bl), met.long(), iters)


def cone_violation(v, cones: dict):
    """How far each lane of v lies outside K (= K*), relative to
    1 + ||v||_inf: the largest of -v_i on the orthant and
    ||v_1|| - v_0 on each (mapped) second-order block, or 0."""
    bl = blocks(cones)
    u = rsoc_map(v, bl)
    worst = torch.zeros(v.shape[:1], dtype=v.dtype, device=v.device)
    for off, d in bl.soc:
        ub = u[:, off:off + d]
        worst = torch.maximum(worst, ub[:, 1:].norm(dim=-1) - ub[:, 0])
    lo, k = bl.lin
    if k:
        worst = torch.maximum(worst, (-u[:, lo:lo + k]).amax(-1))
    return worst.clamp(min=0.0) / (1.0 + v.abs().amax(-1))


# Every number the judge reads, in the order they are printed.  A cell
# compares those its configuration gives a limit.
NUMBERS = ("objective", "primal", "dual", "gap", "complementarity", "cone")


def judge(A, b, c, cones: dict, x, y, s, optimum) -> dict:
    """Each number, per lane, as float64 tensors, whatever the status the
    answer came with.  `objective`: |c'x - p*| / (1 + |p*|) against the
    reference's optimum p*.  `primal` ||Ax - b|| / (1 + ||b||) and `dual`
    ||A'y + s - c|| / (1 + ||c||), 2-norms, as the upstream's LP
    criterion has them.  `gap`: |c'x - b'y| / (1 + |c'x| + |b'y|).
    `complementarity`: |x's| / (1 + |c'x|).  `cone`: the larger cone
    violation of x and s.  A number that is not finite reads inf."""
    dev = torch.as_tensor(A).device
    f = lambda t: torch.as_tensor(t).to(dev, torch.float64)  # noqa: E731
    A, b, c, x, y, s, optimum = map(f, (A, b, c, x, y, s, optimum))
    AT = A.transpose(1, 2)
    rp = ((A @ x[..., None])[..., 0] - b).norm(dim=-1) / (1.0 + b.norm(dim=-1))
    rd = ((AT @ y[..., None])[..., 0] + s - c).norm(dim=-1) \
        / (1.0 + c.norm(dim=-1))
    cx, by = (c * x).sum(-1), (b * y).sum(-1)
    out = {"objective": (cx - optimum).abs() / (1.0 + optimum.abs()),
           "primal": rp, "dual": rd,
           "gap": (cx - by).abs() / (1.0 + cx.abs() + by.abs()),
           "complementarity": (x * s).sum(-1).abs() / (1.0 + cx.abs()),
           "cone": torch.maximum(cone_violation(x, cones),
                                 cone_violation(s, cones))}
    return {k: torch.where(torch.isfinite(v), v, torch.full_like(v, math.inf))
            for k, v in out.items()}
