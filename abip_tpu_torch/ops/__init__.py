"""Hand-written kernels of the port and their plain PyTorch versions.

Exports what `abip_tpu.ops` exports: the BCSR product (K5), the fused
barrier step (K8) and the fused LP ADMM sprint (K7).
"""
from .spmv import BCSRMatrix, bcsr_matvec
from .prox import fused_barrier_step
from .admm_sprint import fused_admm_sprint

__all__ = ["BCSRMatrix", "bcsr_matvec", "fused_barrier_step",
           "fused_admm_sprint"]
