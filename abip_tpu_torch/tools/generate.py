"""Random instances with known answers, drawn from a numpy seed.

Port of `benchmarks/conic_mini.py` (`_complementary_pair`, `randcone`,
`randqcp`) and `benchmarks/generate.py` (`infeasible_lp`,
`unbounded_lp`), on the port's `ConeSpec`: for the same seed they draw
the same arrays, bit for bit.  Plain numpy; nothing here touches a
device.
"""
from __future__ import annotations

import numpy as np


def _complementary_pair(cones, rng):
    """Boundary x*, s* in K, K* with x*'s* = 0.

    Block order [soc..., rsoc..., free, zero, nonneg].  SOC:
    x = (||v||, v), s = a(||v||, -v).  RSOC (t1, t2, z):
    x = (p, ||z||^2/(2p), z), s = b(x2, x1, -z).  free: s = 0.  zero:
    x = 0, s free (the dual of {0}).  nonneg: a complementary support
    partition."""
    xs, ss = [], []
    for d in cones.soc:
        v = rng.standard_normal(d - 1) if d > 1 else np.zeros(0)
        nv = float(np.linalg.norm(v)) if d > 1 else rng.random() + 0.5
        xs.append(np.concatenate([[nv], v]))
        ss.append((rng.random() + 0.5) * np.concatenate([[nv], -v]))
    for d in cones.rsoc:
        z = rng.standard_normal(d - 2)
        p = rng.random() + 0.5
        q = float(z @ z) / (2.0 * p)
        xs.append(np.concatenate([[p, q], z]))
        ss.append((rng.random() + 0.5) * np.concatenate([[q, p], -z]))
    if cones.free:
        xs.append(rng.standard_normal(cones.free))
        ss.append(np.zeros(cones.free))
    if cones.zero:
        xs.append(np.zeros(cones.zero))
        ss.append(rng.standard_normal(cones.zero))
    if cones.nonneg:
        mask = rng.random(cones.nonneg) < 0.5
        pos = rng.random(cones.nonneg) + 0.5
        xs.append(np.where(mask, pos, 0.0))
        ss.append(np.where(mask, 0.0, pos))
    return np.concatenate(xs), np.concatenate(ss)


def randcone(name: str, m: int, cones, seed: int):
    """Random conic program around a known complementary pair:
    b = A x*, c = A'y* + s*.  Returns (name, A, b, c, cones, c'x*)."""
    rng = np.random.default_rng(seed)
    n = cones.dim
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    A[rng.random((m, n)) < 0.5] = 0.0  # mild sparsity
    xstar, sstar = _complementary_pair(cones, rng)
    ystar = rng.standard_normal(m)
    b = A @ xstar
    c = A.T @ ystar + sstar
    return name, A, b, c, cones, float(c @ xstar)


def randqcp(name: str, m: int, cones, seed: int, q_rank=None):
    """Random conic QP with a known optimum: c = A'y* + s* - Q x*, so
    pobj* = 0.5 x*'Qx* + c'x*.  q_rank None gives a full-rank dense Q
    (M'M + 0.1 I), an int a rank-q_rank Q, "diag" a 1-D diagonal.
    Returns (name, A, b, c, Q, cones, pobj*)."""
    rng = np.random.default_rng(seed)
    n = cones.dim
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    A[rng.random((m, n)) < 0.5] = 0.0
    if q_rank == "diag":
        Q = rng.random(n) + 0.1          # 1-D diagonal
    else:
        r = n if q_rank is None else int(q_rank)
        M = rng.standard_normal((r, n)) / np.sqrt(n)
        Q = M.T @ M + (0.1 * np.eye(n) if q_rank is None else 0.0)
    xstar, sstar = _complementary_pair(cones, rng)
    ystar = rng.standard_normal(m)
    b = A @ xstar
    Qx = Q * xstar if q_rank == "diag" else Q @ xstar
    c = A.T @ ystar + sstar - Qx
    # the reference's product orders, for bit-equal optima
    xQx = float(xstar @ Qx) if q_rank == "diag" else float(xstar @ Q @ xstar)
    return name, A, b, c, Q, cones, 0.5 * xQx + float(c @ xstar)


def infeasible_lp(m=20, n=60, seed=0):
    """Standard-form LP infeasible by a Farkas certificate: y with
    A'y <= -margin and b'y = 1 > 0, so {x >= 0: Ax = b} is empty."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(m)
    y /= np.linalg.norm(y)
    A = rng.standard_normal((m, n))
    margin = 0.1
    viol = A.T @ y + margin          # want A'y <= -margin
    A = A - np.outer(y, np.maximum(viol, 0.0))
    b = y.copy()                     # b'y = 1 > 0
    c = rng.random(n) + 0.5
    if not ((A.T @ y <= -margin + 1e-9).all() and b @ y > 0):
        raise ArithmeticError("the Farkas certificate did not hold")
    return A, b, c


def unbounded_lp(m=20, n=60, seed=0):
    """Standard-form LP unbounded below: a ray d > 0 with Ad = 0 and
    c'd = -1 is built in, and b = A x0 keeps it feasible."""
    rng = np.random.default_rng(seed)
    d = rng.random(n) + 0.1          # strictly positive ray
    A = rng.standard_normal((m, n))
    A = A - np.outer(A @ d, d) / (d @ d)     # Ad = 0
    x0 = rng.random(n) + 0.5
    b = A @ x0
    c = rng.standard_normal(n)
    c = c - ((c @ d) + 1.0) * d / (d @ d)    # c'd = -1 < 0
    if not (abs(c @ d + 1.0) < 1e-9 and np.abs(A @ d).max() < 1e-9):
        raise ArithmeticError("the unbounded ray did not hold")
    return A, b, c
