"""ABIP in PyTorch: the LP and conic solvers on CUDA.

A port of `abip_tpu` to PyTorch: the host LP driver (`solve_lp`, one LP
on a dense or scipy sparse A), the host conic driver (`solve_qcp`,
`ConicWorkspace`: one SOCP or QP), the readers of MPS, CBF and SeDuMi
files (`io`, and `python -m abip_tpu_torch FILE`), the batched LP
solver with its delta, steps, sprint and two-phase sprint2 engines
(`solve_lp_batch`), and the
two-phase batched conic path (`solve_qcp_batch`: barrier ladder or
one-stage sprints, then the anchored-delta endgame).  Their hot loops
run hand-written CUDA C++ kernels for Hopper (`csrc/bcsr_spmv.cu`,
`csrc/admm_delta.cu`, `csrc/admm_sprint.cu`, `csrc/conic_ladder.cu`,
`csrc/conic_sprint.cu`, `csrc/conic_delta.cu`, and `csrc/barrier_step.cu`
behind `ops.fused_barrier_step`).  Every entry point runs on the CUDA
card unless the caller passes `device="cpu"` (or another device);
without a visible card and no device given, it raises.  Importing this package sets no
global state.

Quick start::

    import scipy.sparse as sp
    import abip_tpu_torch
    sol = abip_tpu_torch.solve_lp(sp.csr_matrix(A), b, c, eps=1e-6)
    sol = abip_tpu_torch.solve_lp(sp.csr_matrix(A), b, c, eps=1e-6,
                                  device="cpu")

    from abip_tpu_torch import ConeSpec, solve_qcp
    sol = solve_qcp(A, b, c, ConeSpec(soc=(5,), nonneg=10), eps=1e-6)
    sol = solve_qcp(A, b, c, ConeSpec.lp(n), Q=Q, eps=1e-6, device="cpu")

    from abip_tpu_torch import solve_lp_batch, solve_qcp_batch
    res = solve_lp_batch(As, bs, cs, eps=1e-6, engine="delta",
                         precision="mixed", qres_period=1536,
                         avg_period=20)
    res = solve_qcp_batch(As, bs, cs, cones=ConeSpec(soc=(5,), nonneg=10),
                          engine="sprint2", eps=1e-6, precision="mixed",
                          normalize=True, rho_y=1e-3, max_admm=1_000_000,
                          inner_crit_period=512, probe_period=8)
"""
from .settings import Settings, Status
from .cones import ConeSpec
from .dispatch import solve
from .lp import LPSolution, LPWorkspace, solve_lp
from .qcp import ConicSolution, ConicWorkspace, conic_defaults, solve_qcp
from .problem import LinearOperator
from .parallel.batched import solve_lp_batch
from .parallel.batched_qcp import solve_qcp_batch
from .problems import solve_lasso, solve_svm

__version__ = "0.3.0"

__all__ = ["ConeSpec", "ConicSolution", "ConicWorkspace", "LinearOperator",
           "LPSolution", "LPWorkspace", "Settings", "Status",
           "conic_defaults", "solve", "solve_lasso", "solve_lp",
           "solve_lp_batch", "solve_qcp", "solve_qcp_batch", "solve_svm",
           "__version__"]
