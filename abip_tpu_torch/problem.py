"""Problem operators: the matrix-free abstraction of the constraint matrix.

Port of `abip_tpu/problem.py`, the analogue of the reference's
`spe_problem` vtable (`src/abip-qcp/include/abip.h:29-60`): a pair of
closures `matvec`/`rmatvec` over tensors, which live on the caller's
device.  The sparse operator packs A and A' once, where the reference
would take BCSR tiles as the compact rows K5 reads, else as ELL rows, by
the reference's fill estimate.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class LinearOperator:
    """A (possibly matrix-free) linear map R^n -> R^m.

    Attributes
    ----------
    matvec:  x (n,) -> A @ x (m,)
    rmatvec: y (m,) -> A.T @ y (n,)
    dense:   optional thunk returning the dense (m, n) matrix, used by the
             direct linsys backend.
    operands: {name: tensor}, every tensor the products read, or None
             where the operator does not name them.  An operator built by
             `over` names them and can be rebuilt over substitutes
             (`with_operands`), as a CUDA graph's static buffers.
    """

    def __init__(
        self,
        m: int,
        n: int,
        matvec: Callable,
        rmatvec: Callable,
        dense: Optional[Callable] = None,
        nnz: Optional[int] = None,
    ):
        self.m = int(m)
        self.n = int(n)
        self.matvec = matvec
        self.rmatvec = rmatvec
        self._dense = dense
        # nnz drives the sparsity-ratio heuristics of the barrier schedule
        # (`src/abip-lp/src/abip.c:2104-2115`); dense operators report full.
        self.nnz = int(nnz) if nnz is not None else m * n
        self.operands = None
        self._bind = self._dense_name = None

    @classmethod
    def over(cls, m: int, n: int, operands: dict, bind: Callable,
             nnz: Optional[int] = None,
             dense: Optional[str] = None) -> "LinearOperator":
        """The operator whose products read the tensors `operands`
        ({name: tensor}) alone: `bind(operands)` makes its (matvec,
        rmatvec).  `dense` names the operand that is the dense matrix,
        if one is."""
        operands = dict(operands)
        op = cls(m, n, *bind(operands), nnz=nnz,
                 dense=None if dense is None else lambda: operands[dense])
        op.operands, op._bind, op._dense_name = operands, bind, dense
        return op

    def with_operands(self, tensors: dict) -> "LinearOperator":
        """This operator over `tensors` ({name: tensor}, each of its
        operands' names, shapes and dtypes) in their place; its other
        attributes carry over."""
        if self.operands is None:
            raise ValueError("the operator does not name its operands")
        if set(tensors) != set(self.operands) or any(
                t.shape != self.operands[k].shape
                or t.dtype != self.operands[k].dtype
                for k, t in tensors.items()):
            raise ValueError("substitutes must match the operands' names, "
                             "shapes and dtypes")
        op = self.over(self.m, self.n, tensors, self._bind, nnz=self.nnz,
                       dense=self._dense_name)
        for k, v in vars(self).items():
            op.__dict__.setdefault(k, v)
        return op

    @property
    def has_dense(self) -> bool:
        return self._dense is not None

    def dense(self) -> torch.Tensor:
        if self._dense is None:
            raise ValueError("operator has no dense representation")
        return self._dense()

    @property
    def sparsity(self) -> float:
        return self.nnz / max(1, self.m * self.n)

    @classmethod
    def from_dense(cls, A: torch.Tensor,
                   nnz: Optional[int] = None) -> "LinearOperator":
        m, n = A.shape
        return cls.over(m, n, {"A": A}, _dense_products, nnz=nnz, dense="A")

    @classmethod
    def from_scipy_sparse(cls, A, dtype=torch.float64, layout: str = "auto",
                          device="cpu") -> "LinearOperator":
        """Sparse operator backed by the `ops/` products.

        Both A and A' are packed once at setup (the reference stores an
        explicit transpose too, `linsys/indirect.c:290-300`).  `layout`
        picks between "bcsr" (block-structured sparsity, where the
        reference takes (8,128) tiles; here the compact rows of the
        stored entries, K5) and padded-row ELL (scattered sparsity,
        gather + reduce); "auto" chooses ELL when BCSR tiles would be
        mostly padding.
        """
        import numpy as np
        import scipy.sparse as sp

        from .ops.ell import ELLMatrix, ell_matvec
        from .ops.spmv import BCSRMatrix, bcsr_matvec

        A = sp.csr_matrix(A)
        m, n = A.shape
        if layout == "auto":
            layout = "bcsr" if bcsr_fill_estimate(A) > 0.05 else "ell"
        if layout not in ("bcsr", "ell"):
            raise ValueError(f"unknown layout: {layout!r}")

        if layout == "ell":
            E = ELLMatrix.from_scipy(A, dtype=dtype, device=device)
            ET = ELLMatrix.from_scipy(A.T.tocsr(), dtype=dtype, device=device)
            op = cls(m, n, matvec=lambda x: ell_matvec(E, x),
                     rmatvec=lambda y: ell_matvec(ET, y), nnz=int(A.nnz))
            op.ell, op.ell_T = E, ET
        else:
            B = BCSRMatrix.from_scipy(A, dtype=dtype, device=device)
            BT = BCSRMatrix.from_scipy(A.T.tocsr(), dtype=dtype, device=device)
            op = cls(m, n, matvec=lambda x: bcsr_matvec(B, x),
                     rmatvec=lambda y: bcsr_matvec(BT, y), nnz=int(A.nnz))
            op.bcsr, op.bcsr_T = B, BT
        op.layout = layout
        sq = A.copy()
        sq.data = sq.data**2
        f64 = torch.float64
        op.row_norms_sq = torch.as_tensor(np.asarray(sq.sum(axis=1)).ravel(),
                                          dtype=f64, device=device)
        op.col_norms_sq = torch.as_tensor(np.asarray(sq.sum(axis=0)).ravel(),
                                          dtype=f64, device=device)
        return op


def _dense_products(operands):
    A = operands["A"]
    return (lambda x: A @ x), (lambda y: A.T @ y)


def bcsr_fill_estimate(A) -> float:
    """Estimated BCSR tile fill of a CSR matrix: nnz over the padded tile
    volume, the tiles per block row estimated from the first 64 block
    rows (`abip_tpu/problem.py:96-109`)."""
    import numpy as np

    m = A.shape[0]
    br = -(-m // 8)
    probe = min(br, 64)
    touched = 0
    for g in range(probe):
        idx = A[g * 8:min((g + 1) * 8, m)].indices // 128
        touched += len(np.unique(idx)) if len(idx) else 0
    est_tiles = touched / max(1, probe) * br
    return A.nnz / max(1.0, est_tiles * 8 * 128)
