"""Batched solvers: many instances, one lane each, solved together."""
from .batched import device_solve_lp, solve_lp_batch, solve_lp_suite
from .batched_qcp import (pad_conic_instances, prepare_conic_batch,
                          solve_qcp_batch, solve_qcp_device,
                          solve_qcp_het_batch)

__all__ = [
    "device_solve_lp",
    "solve_lp_batch",
    "solve_lp_suite",
    "pad_conic_instances",
    "prepare_conic_batch",
    "solve_qcp_batch",
    "solve_qcp_device",
    "solve_qcp_het_batch",
]
