"""ELL (padded-row) sparse format for scattered sparsity.

Port of `abip_tpu/ops/ell.py`.  BCSR (8,128) tiles suit block-structured
sparsity; for scattered patterns (graph Laplacians, PageRank LPs with ~10
nonzeros per row) each tile holds O(1) nonzeros and the padding explodes.
ELL stores exactly `K` = max-nnz-per-row entries per row:

    data (n_rows, K), cols (n_rows, K)     y[i] = sum_k data[i,k]*x[cols[i,k]]

The reference computes the product with an XLA gather and a row sum (no
Pallas kernel), so plain PyTorch ops are its faithful port.
`LinearOperator.from_scipy_sparse` picks ELL when BCSR tile fill is poor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ELLMatrix:
    data: torch.Tensor    # (m, K)
    cols: torch.Tensor    # (m, K) int32; padded entries point at col 0 with 0 data
    shape: tuple
    nnz: int

    @classmethod
    def from_scipy(cls, A, dtype=torch.float64, device="cpu") -> "ELLMatrix":
        """Pack each CSR row's stored entries, in their stored order, into
        the first slots of its padded row."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        m, n = A.shape
        counts = np.diff(A.indptr)
        K = max(1, int(counts.max()) if len(counts) else 1)
        row = np.repeat(np.arange(m), counts)
        slot = np.arange(A.nnz) - A.indptr[row]
        data = np.zeros((m, K))
        cols = np.zeros((m, K), np.int32)
        data[row, slot] = A.data
        cols[row, slot] = A.indices
        return cls(data=torch.as_tensor(data, dtype=dtype, device=device),
                   cols=torch.as_tensor(cols, device=device),
                   shape=(m, n), nnz=int(A.nnz))


def ell_matvec(A: ELLMatrix, x):
    """y = A @ x via gather + row reduction."""
    gathered = x[A.cols.long()]                  # (m, K)
    return (A.data * gathered.to(A.data.dtype)).sum(dim=1)
