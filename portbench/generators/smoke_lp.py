"""The upstream install test's LP, drawn from a seed.

Frozen copy of `bench.py:39-51` (`reference_smoke_lp`), its reading of
the upstream `test/test_abip_install.m:7-21`: A = [sprand(m, n_rand,
density), I_m], b = A x0, c = A'y0 + s0 with x0, s0 > 0, so the LP is
feasible and bounded (where another reading differs, the configuration's
`reduced` names it).  Kept here so that a change to the program's copy
cannot move the benchmark's inputs.
"""
from __future__ import annotations

import numpy as np


def make(params: dict, seed: int) -> dict:
    """One instance: {"A", "b", "c"} (f64 numpy) of `params` (m,
    n_rand, density) from `seed`."""
    m, n_rand, density = params["m"], params["n_rand"], params["density"]
    rng = np.random.default_rng(seed)
    Ar = rng.standard_normal((m, n_rand)) * (rng.random((m, n_rand)) < density)
    A = np.concatenate([Ar, np.eye(m)], axis=1)
    n = n_rand + m
    x0 = rng.random(n) + 0.5
    y0 = rng.standard_normal(m)
    s0 = rng.random(n) + 0.5
    return {"A": A, "b": A @ x0, "c": A.T @ y0 + s0}
