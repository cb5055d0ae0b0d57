"""Block-sparse (BCSR) matrix-vector product: the port of K5.

Port of `abip_tpu/ops/spmv_pallas.py`.  A scipy sparse matrix is packed
once at setup into padded block rows of (8, 128) tiles (`BCSRMatrix.
from_scipy`, the same arrays as the reference's packing, built by a
vectorized sort instead of a per-nonzero loop); `bcsr_matvec` computes
y = A @ x from them.  On CUDA tensors it launches the hand-written
kernel `csrc/bcsr_spmv.cu` (`bcsr_matvec_cuda`), on CPU tensors it runs
the plain version `_bcsr_ref` (a gather of x tiles and one einsum, the
reference's XLA fallback).  Nothing is compiled when this module is
imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

BR = 8     # tile rows
BC = 128   # tile columns


@dataclasses.dataclass
class BCSRMatrix:
    """Padded block-compressed sparse rows.

    data:  (n_block_rows, max_blocks, BR, BC) tile values (zero-padded)
    cols:  (n_block_rows, max_blocks) int32 block-column ids (0 for pads;
           padded tiles are all-zero so they contribute nothing)
    shape: logical (m, n)
    """

    data: torch.Tensor
    cols: torch.Tensor
    shape: tuple
    nnz: int

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, device="cpu") -> "BCSRMatrix":
        """Pack a scipy sparse matrix: tiles ordered by block row, then
        block column; every stored entry (explicit zeros too) makes its
        tile exist, as in the reference's packing."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        m, n = A.shape
        nbr = -(-m // BR)
        nbc = -(-n // BC)
        coo = A.tocoo()
        row = coo.row.astype(np.int64)
        col = coo.col.astype(np.int64)
        br, bc = row // BR, col // BC
        keys, tile_of = np.unique(br * nbc + bc, return_inverse=True)
        tile_br = keys // nbc
        per_row = np.bincount(tile_br, minlength=nbr)
        max_blocks = max(1, int(per_row.max()) if len(per_row) else 1)
        first = np.concatenate([[0], np.cumsum(per_row)[:-1]])
        slot = np.arange(len(keys)) - first[tile_br]
        data = np.zeros((nbr, max_blocks, BR, BC), np.float64)
        cols = np.zeros((nbr, max_blocks), np.int32)
        cols[tile_br, slot] = keys % nbc
        data[br, slot[tile_of], row - br * BR, col - bc * BC] = coo.data
        return cls(data=torch.as_tensor(data, dtype=dtype, device=device),
                   cols=torch.as_tensor(cols, device=device),
                   shape=(m, n), nnz=int(A.nnz))


def _bcsr_ref(A: BCSRMatrix, x):
    """Plain version: y = A @ x by gathering x's 128-tiles per block and
    one batched tile product (`spmv_pallas.py:224-227`).  x is cast to
    the tiles' dtype and zero-padded to whole tiles."""
    m, n = A.shape
    n_pad = -(-n // BC) * BC
    x_pad = torch.zeros((n_pad,), dtype=A.data.dtype, device=A.data.device)
    x_pad[:n] = x.to(A.data.dtype)
    xs = x_pad.reshape(-1, BC)[A.cols.long()]          # (nbr, maxk, BC)
    return torch.einsum("rkij,rkj->ri", A.data, xs).reshape(-1)[:m]


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from .build import load

    lib = load("bcsr_spmv").lib
    for fn in (lib.abip_bcsr_spmv_f32, lib.abip_bcsr_spmv_f64):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.abip_bcsr_tile.argtypes = []
    lib.abip_bcsr_tile.restype = ctypes.c_int
    lib.abip_cuda_error_string.argtypes = [ctypes.c_int]
    lib.abip_cuda_error_string.restype = ctypes.c_char_p
    if lib.abip_bcsr_tile() != BR * 1000 + BC:
        raise RuntimeError("csrc/bcsr_spmv.cu and its wrapper disagree on "
                           "the tile shape")
    return lib


def bcsr_matvec_cuda(A: BCSRMatrix, x):
    """y = A @ x on the card: one launch of `csrc/bcsr_spmv.cu`, one
    thread block per block row.  x is cast to the tiles' dtype; entries
    of x at and beyond n are never read (the kernel masks them, which
    is the zero padding of the plain version).  Raises on an operand the
    kernel does not take and on a refused launch; never falls back."""
    m, n = A.shape
    data, cols = A.data, A.cols
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"bcsr_matvec_cuda needs CUDA tensors; got {dev}")
    if data.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"BCSR tiles must be f32 or f64; got {data.dtype}")
    nbr, maxk = cols.shape
    if (data.dim() != 4 or tuple(data.shape) != (nbr, maxk, BR, BC)
            or not data.is_contiguous() or nbr != -(-m // BR)):
        raise ValueError(f"BCSR tiles must be contiguous ({nbr}, {maxk}, "
                         f"{BR}, {BC}) for m={m}; got {tuple(data.shape)}")
    if (cols.device != dev or cols.dtype != torch.int32
            or not cols.is_contiguous()):
        raise ValueError("BCSR cols must be contiguous int32 on the tiles' "
                         f"device; got {cols.dtype} on {cols.device}")
    if tuple(x.shape) != (n,) or x.device != dev:
        raise ValueError(f"x must be ({n},) on {dev}; got "
                         f"{tuple(x.shape)} on {x.device}")
    x = x.to(data.dtype).contiguous()
    y = torch.empty((m,), dtype=data.dtype, device=dev)
    lib = _kernel_lib()
    fn = lib.abip_bcsr_spmv_f64 if data.dtype == torch.float64 \
        else lib.abip_bcsr_spmv_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(data.data_ptr(), cols.data_ptr(), x.data_ptr(),
                 y.data_ptr(), nbr, maxk, m, n, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError("bcsr_spmv kernel launch failed: "
                           + lib.abip_cuda_error_string(err).decode())
    bcsr_matvec_cuda.launches += 1
    return y


bcsr_matvec_cuda.launches = 0


def bcsr_matvec(A: BCSRMatrix, x):
    """y = A @ x for a BCSRMatrix; the logical (m,) result in the tiles'
    dtype.  CUDA tensors launch the kernel (or raise); CPU tensors run
    the plain version."""
    if A.data.is_cuda:
        return bcsr_matvec_cuda(A, x)
    if A.data.device.type != "cpu":
        raise ValueError(f"no BCSR product for device {A.data.device}")
    return _bcsr_ref(A, x)
