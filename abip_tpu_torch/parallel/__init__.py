"""Batched solvers: many instances, one lane each, solved together.

  * `batched`: dense LP lanes (`solve_lp_batch`, `solve_lp_suite`);
  * `batched_qcp`: conic lanes (`solve_qcp_batch` and its kin);
  * `sparse_batched`: same-pattern sparse families, sparse products and
    PCG (`solve_lp_batch_coo`);
  * `segmented`: the lane-swap stream (`segmented.solve_lp_stream`);
  * `host_pool`: a thread pool of one-lane solves, one CUDA stream per
    worker (`pool_map`, `solve_lp_pool`).
"""
from .batched import device_solve_lp, solve_lp_batch, solve_lp_suite
from .batched_qcp import (pad_conic_instances, prepare_conic_batch,
                          solve_qcp_batch, solve_qcp_device,
                          solve_qcp_het_batch)
from .sparse_batched import solve_lp_batch_coo
from .host_pool import pool_map, solve_lp_pool

__all__ = [
    "device_solve_lp",
    "solve_lp_batch",
    "solve_lp_batch_coo",
    "solve_lp_suite",
    "pad_conic_instances",
    "prepare_conic_batch",
    "solve_qcp_batch",
    "solve_qcp_device",
    "solve_qcp_het_batch",
    "pool_map",
    "solve_lp_pool",
]
