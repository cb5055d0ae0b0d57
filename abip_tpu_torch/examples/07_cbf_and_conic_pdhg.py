"""Native CBLIB .cbf IO + the conic restarted-PDHG competitor.

Round-trips a conic problem through CBF text, solves it with both the
ADMM interior-point driver and the first-order PDHG competitor, and
checks the two against the construction's known optimum.

Run: python abip_tpu_torch/examples/07_cbf_and_conic_pdhg.py [--cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
from abip_tpu_torch import ConeSpec, solve_qcp_pdhg  # noqa: E402
from abip_tpu_torch.io.cbf import solve_cbf, write_cbf  # noqa: E402
from abip_tpu_torch.tools.generate import randcone  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--cpu", action="store_true",
                help="run on the CPU (default: the CUDA card)")
device = "cpu" if ap.parse_args().cpu else None

name, A, b, c, cones, pobj_star = randcone(
    "demo", 12, ConeSpec(soc=(6,), rsoc=(4,), nonneg=14), seed=1)

with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "demo.cbf")
    write_cbf(path, A, b, c, cones, comment="example instance")
    sol, x, obj = solve_cbf(path, eps=1e-7, device=device)
print(f"ADMM via .cbf : {sol.status_name}, obj {obj:.8f} "
      f"(star {pobj_star:.8f})")

pd = solve_qcp_pdhg(A, b, c, cones, eps=1e-7, device=device)
print(f"conic PDHG    : {pd.status_name}, obj {pd.pobj:.8f} "
      f"in {pd.admm_iters} iterations")
if not (abs(obj - pobj_star) < 1e-5 and abs(pd.pobj - pobj_star) < 1e-5):
    raise SystemExit("an objective is off the known optimum by 1e-5 or more")
