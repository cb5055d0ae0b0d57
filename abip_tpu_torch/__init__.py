"""ABIP in PyTorch: the batched LP and conic solvers on CUDA.

A port of two batched paths of `abip_tpu` to PyTorch: the LP
anchored-delta engine, and the two-phase conic path (barrier ladder,
then the anchored-delta endgame).  Their per-iteration hot loops are
hand-written CUDA C++ kernels for Hopper (`csrc/admm_delta.cu`,
`csrc/conic_ladder.cu`, `csrc/conic_delta.cu`).  Importing this package
sets no global state: every function takes its device from its inputs
and states its dtypes.

Quick start::

    from abip_tpu_torch import ConeSpec, solve_lp_batch, solve_qcp_batch
    res = solve_lp_batch(As, bs, cs, eps=1e-6, engine="delta",
                         precision="mixed", qres_period=1536,
                         avg_period=20, device="cuda")
    res = solve_qcp_batch(As, bs, cs, cones=ConeSpec(soc=(5,), nonneg=10),
                          engine="sprint2", eps=1e-6, precision="mixed",
                          normalize=True, rho_y=1e-3, max_admm=1_000_000,
                          inner_crit_period=512, probe_period=8,
                          device="cuda")
"""
from .settings import Settings, Status
from .cones import ConeSpec
from .parallel.batched import solve_lp_batch
from .parallel.batched_qcp import solve_qcp_batch

__version__ = "0.2.0"

__all__ = ["ConeSpec", "Settings", "Status", "solve_lp_batch",
           "solve_qcp_batch", "__version__"]
