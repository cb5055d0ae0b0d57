"""A random conic program around a known complementary pair.

Frozen copy of `abip_tpu_torch/tools/generate.py:14-59`
(`_complementary_pair` and `randcone`, themselves the port of
`benchmarks/conic_mini.py`), on the benchmark's own cone description:
{"soc": [...], "rsoc": [...], "nonneg": k}, blocks in that order.  The
instance carries its optimum: b = A x*, c = A'y* + s* with x* in K, s* in
K* and x*'s* = 0, so (x*, y*, s*) is optimal and c'x* is the optimal
value.
"""
from __future__ import annotations

import numpy as np


def complementary_pair(cones: dict, rng):
    """Boundary x*, s* in K, K* with x*'s* = 0.  SOC: x = (||v||, v),
    s = a(||v||, -v).  RSOC (t1, t2, z) with 2 t1 t2 >= ||z||^2:
    x = (p, ||z||^2/(2p), z), s = b(x2, x1, -z).  nonneg: a
    complementary support partition."""
    xs, ss = [], []
    for d in cones.get("soc", ()):
        v = rng.standard_normal(d - 1) if d > 1 else np.zeros(0)
        nv = float(np.linalg.norm(v)) if d > 1 else rng.random() + 0.5
        xs.append(np.concatenate([[nv], v]))
        ss.append((rng.random() + 0.5) * np.concatenate([[nv], -v]))
    for d in cones.get("rsoc", ()):
        z = rng.standard_normal(d - 2)
        p = rng.random() + 0.5
        q = float(z @ z) / (2.0 * p)
        xs.append(np.concatenate([[p, q], z]))
        ss.append((rng.random() + 0.5) * np.concatenate([[q, p], -z]))
    k = cones.get("nonneg", 0)
    if k:
        mask = rng.random(k) < 0.5
        pos = rng.random(k) + 0.5
        xs.append(np.where(mask, pos, 0.0))
        ss.append(np.where(mask, 0.0, pos))
    return np.concatenate(xs), np.concatenate(ss)


def make(params: dict, seed: int) -> dict:
    """One instance: {"A", "b", "c", "optimum", "x", "y", "s"} of
    `params` (m, cones) from `seed`, with its optimal (x*, y*, s*); the
    arrays are f64 numpy."""
    m, cones = params["m"], params["cones"]
    rng = np.random.default_rng(seed)
    n = sum(cones.get("soc", ())) + sum(cones.get("rsoc", ())) \
        + cones.get("nonneg", 0)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    A[rng.random((m, n)) < 0.5] = 0.0  # mild sparsity
    xstar, sstar = complementary_pair(cones, rng)
    ystar = rng.standard_normal(m)
    b = A @ xstar
    c = A.T @ ystar + sstar
    return {"A": A, "b": b, "c": c, "optimum": float(c @ xstar),
            "x": xstar, "y": ystar, "s": sstar}
