"""Sparse matrix-vector product of the BCSR layout: the port of K5.

Port of `abip_tpu/ops/spmv_pallas.py`.  A scipy sparse matrix is packed
once at setup (`BCSRMatrix.from_scipy`) into the compact rows of its
stored entries (`rowptr`, `colidx`, `vals`), the only arrays the product
reads.  `bcsr_matvec` computes y = A @ x from them: on CUDA tensors it
launches the hand-written kernel `csrc/bcsr_spmv.cu` (`bcsr_matvec_cuda`);
on CPU tensors it runs that kernel's plain version `_csr_ref`.
`_bcsr_ref` is the product the reference computes: it packs the same
entries into the reference's padded block rows of (8, 128) tiles
(`bcsr_tiles`, on the CPU), gathers x tiles and does one einsum, as the
reference's XLA fallback does.  The two differ only where x is not
finite at a column a row does not store: the tiles multiply that
unstored zero by x (0 * NaN = NaN), the stored entries never touch it.
Nothing is compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

BR = 8     # tile rows
BC = 128   # tile columns
# The kernel gives each row a group of G threads, G a power of two in
# [GROUP_MIN, GROUP_MAX], about ENTRIES_PER_THREAD stored entries a thread
# at the matrix's mean row length.
GROUP_MIN, GROUP_MAX = 4, 256
ENTRIES_PER_THREAD = 4


def csr_group_size(nnz: int, m: int) -> int:
    """Threads per row for a matrix of `m` rows and `nnz` stored entries:
    the power of two at or above mean row length / ENTRIES_PER_THREAD,
    clamped to [GROUP_MIN, GROUP_MAX]."""
    want = -(-nnz // max(1, m * ENTRIES_PER_THREAD))
    g = GROUP_MIN
    while g < want and g < GROUP_MAX:
        g *= 2
    return g


@dataclasses.dataclass
class BCSRMatrix:
    """The compact rows of a sparse matrix's stored entries: the operand
    of K5, for the matrices the reference packs as BCSR tiles.

    shape:  logical (m, n)
    nnz:    stored entries (duplicates summed)
    rowptr: (m + 1,) int32 start of each row in colidx/vals
    colidx: (nnz,) int32 column of each stored entry, ascending in a row
    vals:   (nnz,) its value (explicit zeros kept)
    group:  threads per row of the kernel (`csr_group_size`)
    """

    shape: tuple
    nnz: int
    rowptr: torch.Tensor
    colidx: torch.Tensor
    vals: torch.Tensor
    group: int

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, device="cpu") -> "BCSRMatrix":
        """Pack a scipy sparse matrix: duplicates summed, columns
        ascending in each row, explicit zeros kept."""
        import scipy.sparse as sp

        csr = sp.csr_matrix(A).copy()
        csr.sum_duplicates()            # sorts each row; keeps stored zeros
        if csr.nnz >= 2**31:
            raise ValueError(f"{csr.nnz} stored entries: the kernel indexes "
                             "them with int32")
        m, _ = csr.shape
        return cls(shape=csr.shape, nnz=int(csr.nnz),
                   rowptr=torch.as_tensor(csr.indptr.astype(np.int32),
                                          device=device),
                   colidx=torch.as_tensor(csr.indices.astype(np.int32),
                                          device=device),
                   vals=torch.as_tensor(csr.data, dtype=dtype, device=device),
                   group=csr_group_size(csr.nnz, m))

    @property
    def padded_shape(self):
        """The reference's padded shape: (rows rounded up to whole tile
        rows, None)."""
        return (-(-self.shape[0] // BR) * BR, None)

    @property
    def density_blocks(self) -> float:
        """The reference's tile density: the most tiles of any block row
        of `bcsr_tiles` over the block columns."""
        return bcsr_tiles(self)[1].shape[1] / max(1, -(-self.shape[1] // BC))


def bcsr_tiles(A: BCSRMatrix):
    """The reference's packing of the same entries, on the CPU: `data`
    (n_block_rows, max_blocks, BR, BC) zero-padded tiles in the values'
    dtype, ordered by block row, then block column, and `cols`
    (n_block_rows, max_blocks) int32 block-column ids (0 for pads).
    Every stored entry, an explicit zero too, makes its tile exist."""
    m, n = A.shape
    nbr, nbc = -(-m // BR), -(-n // BC)
    rowptr = A.rowptr.cpu().numpy().astype(np.int64)
    row = np.repeat(np.arange(m, dtype=np.int64), np.diff(rowptr))
    col = A.colidx.cpu().numpy().astype(np.int64)
    br, bc = row // BR, col // BC
    keys, tile_of = np.unique(br * nbc + bc, return_inverse=True)
    tile_br = keys // nbc
    per_row = np.bincount(tile_br, minlength=nbr)
    max_blocks = max(1, int(per_row.max()) if len(per_row) else 1)
    first = np.concatenate([[0], np.cumsum(per_row)[:-1]])
    slot = np.arange(len(keys)) - first[tile_br]
    vals = A.vals.cpu()
    data = torch.zeros((nbr, max_blocks, BR, BC), dtype=vals.dtype)
    cols = np.zeros((nbr, max_blocks), np.int32)
    cols[tile_br, slot] = keys % nbc
    idx = ((br * max_blocks + slot[tile_of]) * BR + row - br * BR) * BC \
        + col - bc * BC
    data.view(-1)[torch.as_tensor(idx)] = vals
    return data, torch.as_tensor(cols)


def _bcsr_ref(A: BCSRMatrix, x):
    """The reference's product: y = A @ x by gathering x's 128-tiles per
    block and one batched tile product over `bcsr_tiles`
    (`spmv_pallas.py:224-227`), on the device of the values.  x is cast
    to the values' dtype and zero-padded to whole tiles."""
    m, n = A.shape
    data, cols = (t.to(A.vals.device) for t in bcsr_tiles(A))
    n_pad = -(-n // BC) * BC
    x_pad = torch.zeros((n_pad,), dtype=data.dtype, device=data.device)
    x_pad[:n] = x.to(data.dtype)
    xs = x_pad.reshape(-1, BC)[cols.long()]             # (nbr, maxk, BC)
    return torch.einsum("rkij,rkj->ri", data, xs).reshape(-1)[:m]


def _csr_ref(A: BCSRMatrix, x):
    """The kernel's plain version: y = A @ x over the stored entries only
    (`rowptr`, `colidx`, `vals`), one product per entry summed into its
    row.  x is cast to the values' dtype; only columns a row stores are
    read."""
    m, _ = A.shape
    rows = torch.repeat_interleave(
        torch.arange(m, device=A.vals.device), torch.diff(A.rowptr.long()))
    prod = A.vals * x.to(A.vals.dtype)[A.colidx.long()]
    return torch.zeros((m,), dtype=A.vals.dtype,
                       device=A.vals.device).index_add_(0, rows, prod)


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from .build import load

    lib = load("bcsr_spmv").lib
    for fn in (lib.abip_csr_spmv_f32, lib.abip_csr_spmv_f64):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.abip_csr_group_range.argtypes = []
    lib.abip_csr_group_range.restype = ctypes.c_int
    lib.abip_cuda_error_string.argtypes = [ctypes.c_int]
    lib.abip_cuda_error_string.restype = ctypes.c_char_p
    if lib.abip_csr_group_range() != GROUP_MIN * 1000 + GROUP_MAX:
        raise RuntimeError("csrc/bcsr_spmv.cu and its wrapper disagree on "
                           "the group sizes")
    return lib


def bcsr_matvec_cuda(A: BCSRMatrix, x):
    """y = A @ x on the card: one launch of `csrc/bcsr_spmv.cu` over the
    stored entries, a group of `A.group` threads per row.  x is cast to
    the values' dtype; only the columns a row stores are read.  Raises on
    an operand the kernel does not take and on a refused launch; never
    falls back."""
    m, n = A.shape
    rowptr, colidx, vals = A.rowptr, A.colidx, A.vals
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"bcsr_matvec_cuda needs CUDA tensors; got {dev}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"values must be f32 or f64; got {vals.dtype}")
    nnz = vals.numel()
    if nnz >= 2**31:
        raise ValueError(f"{nnz} stored entries: the kernel indexes them "
                         "with int32")
    g = A.group
    if g < GROUP_MIN or g > GROUP_MAX or g & (g - 1):
        raise ValueError(f"group size {g} is not a power of two in "
                         f"[{GROUP_MIN}, {GROUP_MAX}]")
    for name, t, size, dt in (("rowptr", rowptr, m + 1, torch.int32),
                              ("colidx", colidx, nnz, torch.int32),
                              ("vals", vals, nnz, vals.dtype)):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != (size,)
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{dt} ({size},) on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if tuple(x.shape) != (n,) or x.device != dev:
        raise ValueError(f"x must be ({n},) on {dev}; got "
                         f"{tuple(x.shape)} on {x.device}")
    x = x.to(vals.dtype).contiguous()
    y = torch.empty((m,), dtype=vals.dtype, device=dev)
    lib = _kernel_lib()
    fn = lib.abip_csr_spmv_f64 if vals.dtype == torch.float64 \
        else lib.abip_csr_spmv_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rowptr.data_ptr(), colidx.data_ptr(), vals.data_ptr(),
                 x.data_ptr(), y.data_ptr(), m, g, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError("bcsr_spmv kernel launch failed: "
                           + lib.abip_cuda_error_string(err).decode())
    bcsr_matvec_cuda.launches += 1
    return y


bcsr_matvec_cuda.launches = 0


def bcsr_matvec(A: BCSRMatrix, x):
    """y = A @ x for a BCSRMatrix; the logical (m,) result in the values'
    dtype.  CUDA tensors launch the kernel (or raise); CPU tensors run
    its plain version."""
    if A.vals.is_cuda:
        return bcsr_matvec_cuda(A, x)
    if A.vals.device.type != "cpu":
        raise ValueError(f"no BCSR product for device {A.vals.device}")
    return _csr_ref(A, x)
