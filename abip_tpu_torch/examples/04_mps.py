"""Solve an MPS file end-to-end (general form -> standard form -> solve).

Run: python abip_tpu_torch/examples/04_mps.py [FILE.mps] [--cpu]
(defaults to a committed netlib-mini instance)
"""
import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)
from abip_tpu_torch.io.presolve import solve_mps  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("path", nargs="?", default=os.path.join(
    ROOT, "benchmarks", "suites", "netlib_mini", "blend01.mps"))
ap.add_argument("--cpu", action="store_true",
                help="run on the CPU (default: the CUDA card)")
args = ap.parse_args()

sol, std = solve_mps(args.path, eps=1e-6, device="cpu" if args.cpu else None)
print(f"{sol.status_name}: objective {sol.pobj:.8f} "
      f"({sol.ipm_iters} IPM / {sol.admm_iters} ADMM iterations)")
