"""Randomized conic validation with exact complementary-pair oracles.

Port of `tools/fuzz_conic.py`.  Each instance is a random conic program
built around a KNOWN boundary-complementary primal-dual pair
(`generate.randcone`, `generate.randqcp`), so its exact optimal
objective is known without an external solver.  Pass criteria per
solved instance, each under 50*eps:

  * objective distance to the exact oracle, relative to max(1, |star|);
  * KKT at the returned point: primal feasibility and complementarity;
  * cone membership of x in K and of s in K*.

Classes cover the cone set {nonneg, SOC, RSOC, free, zero, mixed} and
three quadratic terms (diagonal, full, low rank).  One JSON line per
instance, then a summary; exit code 1 on any mismatch.

Routes: the host conic driver (`solve_qcp`, conic defaults), one
batched solve per class (`--batched`: `solve_qcp_batch`, mixed
precision with the built-in equilibration, engine "steps" or "sprint2";
a full Q always takes "steps"), or restarted PDHG (`--method pdhg`, the
classes without Q).  Everything runs on the CUDA card unless `--cpu`::

    python -m abip_tpu_torch.tools.fuzz_conic --per-class 20 -o out.jsonl
    python -m abip_tpu_torch.tools.fuzz_conic --batched --engine sprint2
"""
from __future__ import annotations

import argparse
import json
import time
import zlib

import numpy as np

from ..cones import ConeSpec
from ..parallel.batched_qcp import solve_qcp_batch
from ..pdhg import solve_qcp_pdhg
from ..qcp import conic_defaults, solve_qcp
from ..settings import Status
from .generate import randcone, randqcp


def cone_violation(v, cones, dual=False):
    """Max violation of membership v in K (dual=False) or K* (dual=True).

    soc/rsoc/nonneg are self-dual; the free block is unconstrained in K
    but must be 0 in K* (dual of a subspace), and the zero block must be
    0 in K but is unconstrained in K*.
    """
    viol = 0.0
    o = 0
    for d in cones.soc:
        blk = v[o:o + d]
        viol = max(viol, float(np.linalg.norm(blk[1:]) - blk[0]))
        o += d
    for d in cones.rsoc:
        blk = v[o:o + d]
        viol = max(viol,
                   float(np.linalg.norm(blk[2:]) ** 2
                         - 2.0 * max(blk[0], 0.0) * max(blk[1], 0.0)),
                   float(-blk[0]), float(-blk[1]))
        o += d
    if cones.free and dual:
        viol = max(viol, float(np.abs(v[o:o + cones.free]).max()))
    o += cones.free
    if cones.zero and not dual:
        viol = max(viol, float(np.abs(v[o:o + cones.zero]).max()))
    o += cones.zero
    if cones.nonneg:
        viol = max(viol, float(-(v[o:]).min()) if v[o:].size else 0.0)
    return viol


CLASSES = {
    "nonneg": lambda C: C(nonneg=25),
    "soc": lambda C: C(soc=(8, 5), nonneg=10),
    "rsoc": lambda C: C(rsoc=(7, 4), nonneg=8),
    "free_mixed": lambda C: C(soc=(6,), free=4, nonneg=12),
    "mixed": lambda C: C(soc=(5,), rsoc=(4,), free=3, nonneg=9),
    "zero_mixed": lambda C: C(soc=(6,), free=2, zero=3, nonneg=10),
}

# quadratic-objective classes (randqcp oracle): q_rank "diag", None (full)
# or a rank; excluded from --method pdhg (no closed prox for coupled Q)
QP_CLASSES = {
    "qp_diag": (lambda C: C(soc=(6,), nonneg=14), "diag"),
    "qp_full": (lambda C: C(soc=(5,), rsoc=(4,), nonneg=11), None),
    "qp_lowrank": (lambda C: C(nonneg=20), 3),
}

# the batched engines: "delta" is an endgame (it resumes a prior phase's
# state), so it runs only inside "sprint2", never from a cold start
ENGINES = ("steps", "sprint2")
METHODS = ("admm", "pdhg")


def class_names(method="admm"):
    """The classes a run covers, in order: PDHG skips the QP classes."""
    return list(CLASSES) + ([] if method == "pdhg" else list(QP_CLASSES))


def instances(cls, per_class):
    """(cones, [(name, A, b, c, Q or None, pobj_star)]) of one class:
    instance i drawn from the seed crc32("conic:{cls}:{i}"),
    m = max(6, dim // 3)."""
    is_qp = cls in QP_CLASSES
    make, q_rank = QP_CLASSES[cls] if is_qp else (CLASSES[cls], None)
    cones = make(ConeSpec)
    m = max(6, cones.dim // 3)
    out = []
    for i in range(per_class):
        seed = zlib.crc32(f"conic:{cls}:{i}".encode())
        if is_qp:
            nm, A, b, c, Q, _cn, star = randqcp(f"{cls}{i}", m, cones, seed,
                                                q_rank=q_rank)
        else:
            nm, A, b, c, _cn, star = randcone(f"{cls}{i}", m, cones, seed)
            Q = None
        out.append((nm, A, b, c, Q, star))
    return cones, out


def class_engine(cls, engine):
    """The engine a batch of class `cls` runs: a full (2-D) Q forces
    "steps" (the fused phase-1 and delta kernels take a diagonal Q
    only)."""
    full_q = cls in QP_CLASSES and QP_CLASSES[cls][1] != "diag"
    return "steps" if full_q else engine


class _Lane:
    """One lane of a batch result, in the fields a solution has."""

    def __init__(self, rb, i):
        self.status_name = Status.name(int(rb.status[i]))
        self.admm_iters = int(rb.admm_iters[i])
        self.pobj = float(rb.pobj[i])
        self.x, self.y, self.s = (f[i].cpu().numpy()
                                  for f in (rb.x, rb.y, rb.s))


def record(cls, i, sol, A, b, cones, pobj_star, wall, eps):
    """The JSON record of one instance and its pass verdict."""
    rec = {"class": cls, "i": i, "status": sol.status_name,
           "admm": int(sol.admm_iters), "time": round(wall, 3)}
    ok = sol.status_name.startswith("Solved")
    if ok:
        rec["obj_err"] = float(
            abs(sol.pobj - pobj_star) / max(1.0, abs(pobj_star)))
        x, s = sol.x, sol.s
        pres = np.linalg.norm(A @ x - b) / (1 + np.linalg.norm(b))
        comp = abs(float(x @ s)) / (1 + abs(sol.pobj))
        rec["kkt"] = float(max(pres, comp))
        rec["cone_viol_x"] = float(cone_violation(x, cones))
        rec["cone_viol_s"] = float(cone_violation(s, cones, dual=True))
        tol = 50 * eps
        ok = (rec["obj_err"] < tol and rec["kkt"] < tol
              and rec["cone_viol_x"] < tol and rec["cone_viol_s"] < tol)
    rec["ok"] = bool(ok)
    return rec


def run_class(cls, per_class, eps=1e-6, *, batched=False, engine="steps",
              method="admm", device=None):
    """Solve `per_class` instances of class `cls` by one route and return
    their records.  `device` None is the CUDA card."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}; got {engine!r}")
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}; got {method!r}")
    if method == "pdhg" and cls in QP_CLASSES:
        raise ValueError(f"PDHG takes no quadratic term; class {cls!r} has "
                         "one")
    cones, insts = instances(cls, per_class)
    recs = []
    if batched:
        Qs = None if insts[0][4] is None else np.stack([t[4] for t in insts])
        t0 = time.perf_counter()
        # rho_y=1e-3: the mixed f32 Schur factor needs cond(S) ~ 1/rho_y
        # manageable; max_admm is the TOTAL budget over barrier stages
        rb = solve_qcp_batch(*(np.stack([t[k] for t in insts])
                               for k in (1, 2, 3)), Qs, cones=cones,
                             eps=eps, precision="mixed", normalize=True,
                             rho_y=1e-3, max_admm=1_000_000,
                             engine=class_engine(cls, engine),
                             device=device)
        lanes = [_Lane(rb, i) for i in range(per_class)]
        wall = (time.perf_counter() - t0) / per_class
    for i, (_name, A, b, c, Q, pobj_star) in enumerate(insts):
        t0 = time.perf_counter()
        if batched:
            sol = lanes[i]
        elif method == "pdhg":
            sol = solve_qcp_pdhg(A, b, c, cones, eps=eps,
                                 max_iters=1_000_000, device=device)
        else:
            sol = solve_qcp(A, b, c, cones, Q=Q, settings=conic_defaults(),
                            eps=eps, device=device)
        if not batched:
            wall = time.perf_counter() - t0
        recs.append(record(cls, i, sol, A, b, cones, pobj_star, wall, eps))
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-class", type=int, default=20)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--batched", action="store_true",
                    help="solve each class as ONE batch (solve_qcp_batch, "
                         "mixed precision + built-in equilibration)")
    ap.add_argument("--engine", default="steps",
                    help="batched engine: steps (default) or sprint2 "
                         "(ladder phase 1, then the delta endgame)")
    ap.add_argument("--method", default="admm", choices=METHODS,
                    help="pdhg = the conic restarted-PDHG competitor "
                         "(solve_qcp_pdhg) under the same KKT contract")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)
    if args.engine == "delta":
        ap.error("--engine delta: the conic delta engine is an endgame "
                 "that resumes a prior phase's state and cannot start "
                 "cold; --engine sprint2 runs it after the ladder")
    if args.engine not in ENGINES:
        ap.error(f"--engine must be one of {', '.join(ENGINES)}; got "
                 f"{args.engine!r}")

    lines = []
    for cls in class_names(args.method):
        for rec in run_class(cls, args.per_class, args.eps,
                             batched=args.batched, engine=args.engine,
                             method=args.method,
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
