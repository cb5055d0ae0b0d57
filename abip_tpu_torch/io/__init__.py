"""Problem IO: MPS reading and presolve to standard form (port of
`abip_tpu/io`).

Replaces the reference's MATLAB front end (`mpsread` +
`scripts/bench-lp/preprocess.m`) with a pure-Python pipeline.
"""
from .mps import read_mps, GeneralLP
from .presolve import presolve_to_standard, StandardFormLP
from .sedumi import from_sedumi, load_sedumi_mat, solve_sedumi
from .cbf import read_cbf, solve_cbf, write_cbf

__all__ = ["read_mps", "GeneralLP", "presolve_to_standard", "StandardFormLP",
           "from_sedumi", "load_sedumi_mat", "solve_sedumi",
           "read_cbf", "solve_cbf", "write_cbf"]
