"""ABIP in PyTorch: the batched LP delta-engine path on CUDA.

A port of the `abip_tpu` batched LP solver (anchored-delta engine) to
PyTorch, with its per-iteration hot loop in one hand-written CUDA C++
kernel for Hopper (`csrc/admm_delta.cu`).  Importing this package sets
no global state: every function takes its device from its inputs and
states its dtypes.

Quick start::

    from abip_tpu_torch import solve_lp_batch
    res = solve_lp_batch(As, bs, cs, eps=1e-6, engine="delta",
                         precision="mixed", qres_period=1536,
                         avg_period=20, device="cuda")
"""
from .settings import Settings, Status
from .parallel.batched import solve_lp_batch

__version__ = "0.1.0"

__all__ = ["Settings", "Status", "solve_lp_batch", "__version__"]
