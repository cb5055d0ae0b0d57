"""The upstream LASSO protocol's instance, drawn from a seed, with its
conic embedding.

Frozen copy of `benchmarks/generate.py:37-47` (`lasso_instance`), the
project's reading of the upstream `get_lasso_simu_data.m` (not in the
repository): X with N(0, 1/m) entries, a sparse w0 with a share
`sparsity` of N(0, 1) entries, y = X w0 + noise N(0, 1), and
lam = 0.1 ||X'y||_inf (`scripts/bench-qcp/test_lasso.m:36-120`).  Beside
(X, y, lam), the call's arguments, it gives the dense embedding the
check judges against, the one `source/lasso_config.c:8-93` builds:

    z = (t1, t2, r in R^m, w+ in R^n, w- in R^n),  K = RSOC(2+m) x R+^2n
    rows  t1 = 1,  r + X w+ - X w- = y;   min t2 + lam 1'(w+ + w-)

Kept here so that a change to the program's copy cannot move the
benchmark's inputs.
"""
from __future__ import annotations

import numpy as np


def embedding(X, y, lam):
    """(A, b, c) of min 1/2 ||X w - y||^2 + lam ||w||_1 in standard
    conic form over RSOC(2+m) x R+^2n."""
    m, n = X.shape
    A = np.zeros((1 + m, 2 + m + 2 * n))
    A[0, 0] = 1.0
    A[1:, 2:2 + m] = np.eye(m)
    A[1:, 2 + m:2 + m + n] = X
    A[1:, 2 + m + n:] = -X
    b = np.concatenate([[1.0], y])
    c = np.zeros(2 + m + 2 * n)
    c[1] = 1.0
    c[2 + m:] = lam
    return A, b, c


def make(params: dict, seed) -> dict:
    """One instance: {"X", "y", "lam", "A", "b", "c"} (f64 numpy, lam a
    float) of `params` (m, n, sparsity, noise) from `seed`."""
    m, n = params["m"], params["n"]
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n)) / np.sqrt(m)
    k = max(1, int(params["sparsity"] * n))
    w = np.zeros(n)
    w[rng.choice(n, k, replace=False)] = rng.standard_normal(k)
    y = X @ w + params["noise"] * rng.standard_normal(m)
    lam = float(0.1 * np.abs(X.T @ y).max())
    A, b, c = embedding(X, y, lam)
    return {"X": X, "y": y, "lam": lam, "A": A, "b": b, "c": c}
