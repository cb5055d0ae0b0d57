"""Randomized LP validation against the scipy-HiGHS oracle.

Port of `tools/fuzz_scipy.py`.  Random instances across shape classes,
solved by `solve_lp` at eps and judged on status and objective:

  * wide, square, degenerate (duplicated columns), near_rank_def (one
    row almost a combination of the others): Solved, the exact KKT test
    at the returned point under 10*eps, x >= -10*eps, and the objective
    within 50*eps of HiGHS (skipped for near_rank_def, whose optimal
    value moves by far more than eps under eps-sized perturbations);
  * infeasible and unbounded (`generate.infeasible_lp`,
    `generate.unbounded_lp`): the status Infeasible or Unbounded.

One JSON line per instance plus a summary; exit code 1 on any mismatch.
Runs on the CUDA card unless `--cpu`::

    python -m abip_tpu_torch.tools.fuzz_scipy --per-class 30 -o out.jsonl
"""
from __future__ import annotations

import argparse
import json
import time
import zlib

import numpy as np
from scipy.optimize import linprog

from ..lp import solve_lp
from .generate import infeasible_lp, unbounded_lp


def gen_random(rng, m, n):
    A = rng.standard_normal((m, n))
    b = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    return A, b, c


def gen_degenerate(rng, m, n):
    """Duplicated columns -> non-unique optima, degenerate vertices."""
    A, b, c = gen_random(rng, m, n // 2)
    A = np.concatenate([A, A], axis=1)
    c = np.concatenate([c, c + 1e-9 * rng.standard_normal(n // 2)])
    return A, b, c


def gen_near_rank_def(rng, m, n):
    """One row is (almost) a combination of others: kappa ~ 1e8."""
    A, b, c = gen_random(rng, m, n)
    w = rng.standard_normal(m - 1)
    A[-1] = w @ A[:-1] + 1e-8 * rng.standard_normal(n)
    x0 = rng.random(n) + 0.5
    b = A @ x0
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    return A, b, c


CLASSES = {
    "wide": lambda rng: gen_random(rng, 20, 80),
    "square": lambda rng: gen_random(rng, 40, 48),
    "degenerate": lambda rng: gen_degenerate(rng, 20, 80),
    "near_rank_def": lambda rng: gen_near_rank_def(rng, 20, 80),
    "infeasible": lambda rng: infeasible_lp(seed=int(rng.integers(1 << 30))),
    "unbounded": lambda rng: unbounded_lp(seed=int(rng.integers(1 << 30))),
}
STATUS_CLASSES = {"infeasible": "Infeasible", "unbounded": "Unbounded"}


def instance(cls, i):
    """(A, b, c) of instance i of class `cls`, drawn from the seed
    crc32("{cls}:{i}")."""
    seed = zlib.crc32(f"{cls}:{i}".encode())  # process-stable
    return CLASSES[cls](np.random.default_rng(seed))


def record(cls, i, sol, A, b, c, wall, eps):
    """The JSON record of one instance and its pass verdict."""
    rec = {"class": cls, "i": i, "status": sol.status_name,
           "admm": int(sol.admm_iters), "time": round(wall, 3)}
    if cls in STATUS_CLASSES:
        rec["ok"] = sol.status_name.startswith(STATUS_CLASSES[cls])
        return rec
    # the contract is the KKT test at the RETURNED point (the reference's
    # has_converged, recomputed exactly); objective agreement with HiGHS
    # is required only on well-conditioned classes
    x, y, s = sol.x, sol.y, sol.s
    pres = np.linalg.norm(A @ x - b) / (1 + np.linalg.norm(b))
    dres = np.linalg.norm(c - A.T @ y - s) / (1 + np.linalg.norm(c))
    gap = abs(c @ x - b @ y) / (1 + abs(c @ x) + abs(b @ y))
    rec["kkt"] = float(max(pres, dres, gap))
    ok = (sol.status_name.startswith("Solved") and rec["kkt"] < 10 * eps
          and x.min() > -10 * eps)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    if ref.status == 0:
        err = abs(sol.pobj - ref.fun) / max(1.0, abs(ref.fun))
        rec["obj_err"] = float(err)
        if cls != "near_rank_def":
            ok = ok and err < 50 * eps
    else:
        # HiGHS refused (its presolve flags numerical trouble on
        # kappa ~ 1e9 rows): the exact KKT test above decides
        rec["scipy_status"] = int(ref.status)
    rec["ok"] = bool(ok)
    return rec


def run_class(cls, per_class, eps=1e-6, *, device=None):
    """Solve `per_class` instances of class `cls` through `solve_lp` and
    return their records.  `device` None is the CUDA card."""
    recs = []
    for i in range(per_class):
        A, b, c = instance(cls, i)
        t0 = time.perf_counter()
        sol = solve_lp(A, b, c, eps=eps, device=device)
        wall = time.perf_counter() - t0
        recs.append(record(cls, i, sol, A, b, c, wall, eps))
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-class", type=int, default=30)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)

    lines = []
    for cls in CLASSES:
        for rec in run_class(cls, args.per_class, args.eps,
                             device="cpu" if args.cpu else None):
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    bad = sum(not rec["ok"] for rec in lines)
    summary = {"total": len(lines), "mismatches": bad,
               "per_class": args.per_class, "eps": args.eps}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            for rec in lines + [summary]:
                f.write(json.dumps(rec) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
