"""`abip_tpu_torch.ops.spmv` and `ops.ell` against the JAX package.

The compact rows the port packs must be scipy's CSR arrays, and the
tiles packed from them (`bcsr_tiles`, the operand of the reference
product `_bcsr_ref`) the reference's arrays exactly (tile order,
`max_blocks`, zero pads with column 0).  The port's product (the plain version of the kernel, over the
stored entries) runs against
the reference's Pallas kernel K5 in interpret mode
(`bcsr_matvec(..., use_pallas=True, interpret=True)`, which runs the
kernel's body on the CPU; with `use_pallas=None` the CPU takes the XLA
fallback instead).  Shapes: the four of `tests/test_ops.py:12-13` and
one with empty block rows and a last block row of fewer tiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu.ops.ell import ELLMatrix as JELL, ell_matvec as j_ell_matvec  # noqa: E402
from abip_tpu.ops.spmv_pallas import (BCSRMatrix as JBCSR,  # noqa: E402
                                      bcsr_matvec as j_bcsr_matvec)
from abip_tpu.problem import LinearOperator as JOp  # noqa: E402
from abip_tpu_torch.ops import spmv  # noqa: E402
from abip_tpu_torch.ops.ell import ELLMatrix, ell_matvec  # noqa: E402
from abip_tpu_torch.problem import LinearOperator  # noqa: E402

SHAPES = [(20, 50, 0.2), (100, 300, 0.05), (8, 128, 1.0), (17, 260, 0.3)]
IDS = ["20x50", "100x300", "8x128", "17x260", "empty-rows"]
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64,
                                                    torch.float64)}
# |port - reference| <= TOL * (|A| |x|) per row: both sum the same products
# in other orders, in the working type
TOL = {"f32": 1e-5, "f64": 1e-12}


def _matrix(case):
    if case == "empty-rows":
        A = sp.random(37, 300, density=0.2,
                      random_state=np.random.RandomState(3), format="lil")
        A[8:24, :] = 0.0          # block rows 1 and 2 hold nothing
        A[30:, 128:] = 0.0        # the last block row has fewer tiles
        return sp.csr_matrix(A)
    m, n, d = SHAPES[IDS.index(case)]
    return sp.random(m, n, density=d, random_state=np.random.RandomState(0),
                     format="csr")


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("case", IDS)
def test_bcsr_packing_equals_reference(case, kind):
    A = _matrix(case)
    jdt, tdt = DTYPES[kind]
    ref = JBCSR.from_scipy(A, dtype=jdt)
    port = spmv.BCSRMatrix.from_scipy(A, dtype=tdt)
    assert port.shape == ref.shape and port.nnz == ref.nnz
    data, cols = spmv.bcsr_tiles(port)
    assert cols.dtype == torch.int32 and data.dtype == tdt
    np.testing.assert_array_equal(cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(data.numpy(), np.asarray(ref.data))


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("case", IDS)
def test_bcsr_matvec_matches_pallas_interpret(case, kind):
    A = _matrix(case)
    jdt, tdt = DTYPES[kind]
    x = np.random.default_rng(1).standard_normal(A.shape[1])
    y_ref = np.asarray(j_bcsr_matvec(JBCSR.from_scipy(A, dtype=jdt),
                                     jnp.asarray(x), use_pallas=True,
                                     interpret=True), np.float64)
    y = spmv.bcsr_matvec(spmv.BCSRMatrix.from_scipy(A, dtype=tdt),
                         torch.as_tensor(x)).double().numpy()
    bound = TOL[kind] * (abs(A) @ np.abs(x)) + 1e-300
    assert (np.abs(y - y_ref) <= bound).all()
    assert (np.abs(y - A @ x) <= bound).all()


def _compact_case(case):
    """The matrices of IDS, one with explicit stored zeros, one that
    stores some entries twice (unsorted, not yet summed), and an A' whose
    rows hold one entry each (A with one full row)."""
    if case == "duplicates":
        A = _matrix("20x50")
        rows = np.repeat(np.arange(20), np.diff(A.indptr))
        pick = np.arange(0, A.nnz, 3)
        data = np.concatenate([A.data, 0.5 * A.data[pick]])
        r = np.concatenate([rows, rows[pick]])
        c = np.concatenate([A.indices, A.indices[pick]])
        order = np.argsort(r, kind="stable")
        indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=20))])
        return sp.csr_matrix((data[order], c[order], indptr), shape=A.shape)
    if case == "explicit-zeros":
        A = _matrix("100x300").copy()
        A.data[::5] = 0.0                   # stored, so packed
        return A
    if case == "transposed-1-entry":
        A = sp.lil_matrix((6, 40))
        A[2, :] = np.arange(1.0, 41.0)
        A[4, 7] = -2.0
        return sp.csr_matrix(A).T.tocsr()
    return _matrix(case)


COMPACT_IDS = IDS + ["explicit-zeros", "duplicates", "transposed-1-entry"]


@pytest.mark.parametrize("case", COMPACT_IDS)
def test_compact_rows_equal_scipy_csr(case):
    """rowptr, colidx and vals are scipy's CSR arrays of the same matrix:
    rows in order, columns ascending, duplicates summed, explicit zeros
    kept; nnz counts the entries the kernel reads."""
    A = _compact_case(case)
    ref = sp.csr_matrix(A).copy()
    ref.sum_duplicates()
    assert (ref.nnz < A.nnz) == (case == "duplicates")
    port = spmv.BCSRMatrix.from_scipy(A, dtype=torch.float64)
    assert port.rowptr.dtype == port.colidx.dtype == torch.int32
    np.testing.assert_array_equal(port.rowptr.numpy(), ref.indptr)
    np.testing.assert_array_equal(port.colidx.numpy(), ref.indices)
    np.testing.assert_array_equal(port.vals.numpy(), ref.data)
    assert port.vals.numel() == ref.nnz == port.nnz


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("case", COMPACT_IDS)
def test_plain_product_over_stored_entries(case, kind):
    """The kernel's plain version over the compact rows equals the tile
    product and scipy's f64 product within TOL of |A| |x| per row."""
    A = _compact_case(case)
    tdt = DTYPES[kind][1]
    x = np.random.default_rng(8).standard_normal(A.shape[1])
    port = spmv.BCSRMatrix.from_scipy(A, dtype=tdt)
    xt = torch.as_tensor(x)
    y = spmv._csr_ref(port, xt).double().numpy()
    tiles = spmv._bcsr_ref(port, xt).double().numpy()
    bound = TOL[kind] * (abs(A) @ np.abs(x)) + 1e-300
    assert (np.abs(y - tiles) <= bound).all()
    assert (np.abs(y - A @ x) <= bound).all()


# the host LP's smoke instance (m=1000, n=10000, 900,310 stored entries):
# A has 819-987 entries a row, A' 1-136 (mean 90)
@pytest.mark.parametrize("nnz,m,group", [
    (900_310, 1000, 256), (900_310, 10_000, 32), (1500, 3, 128),
    (40, 40, 4), (0, 5, 4), (10**7, 10, 256)],
    ids=["smoke-A", "smoke-At", "three-rows", "one-entry-rows", "empty",
         "dense-rows"])
def test_group_size(nnz, m, group):
    assert spmv.csr_group_size(nnz, m) == group


def test_group_size_of_the_packing():
    """The packing fixes the group from the matrix's mean row length."""
    A = _compact_case("transposed-1-entry")
    assert spmv.BCSRMatrix.from_scipy(A).group == spmv.GROUP_MIN
    A = sp.csr_matrix(np.ones((2, 900)))
    assert spmv.BCSRMatrix.from_scipy(A).group == 256


def test_bcsr_ignores_x_past_its_end():
    """A view of x whose buffer holds NaN beyond n: nothing past n is
    read, so the padded tile columns stay clean."""
    A = _matrix("17x260")
    buf = torch.full((300,), float("nan"), dtype=torch.float64)
    buf[:260] = torch.as_tensor(np.random.default_rng(2).standard_normal(260))
    y = spmv.bcsr_matvec(spmv.BCSRMatrix.from_scipy(A, dtype=torch.float64),
                         buf[:260])
    np.testing.assert_allclose(y.numpy(), A @ buf[:260].numpy(), rtol=1e-12,
                               atol=1e-12)


def test_bcsr_dispatch_by_device():
    """CPU tensors take the plain version (no launch counted); the kernel
    wrapper refuses CPU tensors rather than fall back."""
    B = spmv.BCSRMatrix.from_scipy(_matrix("20x50"), dtype=torch.float64)
    before = spmv.bcsr_matvec_cuda.launches
    spmv.bcsr_matvec(B, torch.ones(50, dtype=torch.float64))
    assert spmv.bcsr_matvec_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        spmv.bcsr_matvec_cuda(B, torch.ones(50, dtype=torch.float64))


@pytest.mark.parametrize("case", IDS)
def test_bcsr_padded_shape_and_density_equal_reference(case):
    A = _matrix(case)
    ref = JBCSR.from_scipy(A)
    port = spmv.BCSRMatrix.from_scipy(A)
    assert port.padded_shape == ref.padded_shape
    assert port.density_blocks == ref.density_blocks


@pytest.mark.parametrize("case", ["100x300", "empty-rows"])
def test_ell_fill_equals_reference(case):
    A = _matrix(case)
    assert ELLMatrix.from_scipy(A).fill == JELL.from_scipy(A).fill


@pytest.mark.parametrize("case", ["100x300", "empty-rows"])
def test_ell_packing_and_matvec(case):
    A = _matrix(case)
    ref = JELL.from_scipy(A)
    port = ELLMatrix.from_scipy(A)
    assert port.shape == ref.shape and port.nnz == ref.nnz
    np.testing.assert_array_equal(port.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    x = np.random.default_rng(4).standard_normal(A.shape[1])
    y = ell_matvec(port, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(
        y, np.asarray(j_ell_matvec(ref, jnp.asarray(x))), rtol=1e-12,
        atol=1e-12 * np.abs(x).max())


def _scattered(m=40, n=600, seed=5):
    """About 3 nonzeros per row: BCSR tiles would be mostly padding."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.005, random_state=np.random.RandomState(
        seed), format="lil")
    A[np.arange(m), rng.integers(0, n, m)] = 1.0 + rng.random(m)
    return sp.csr_matrix(A)


@pytest.mark.parametrize("case", ["block", "scattered"])
def test_layout_choice_matches_reference(case):
    """`from_scipy_sparse(layout="auto")` picks what the reference picks,
    and both products and the row/column norms agree."""
    A = _matrix("17x260") if case == "block" else _scattered()
    ref = JOp.from_scipy_sparse(A)
    port = LinearOperator.from_scipy_sparse(A, device="cpu")
    assert port.layout == ("ell" if hasattr(ref, "ell") else "bcsr")
    assert port.layout == ("bcsr" if case == "block" else "ell")
    assert port.nnz == ref.nnz
    rng = np.random.default_rng(6)
    x, y = rng.standard_normal(A.shape[1]), rng.standard_normal(A.shape[0])
    np.testing.assert_allclose(port.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port.rmatvec(torch.as_tensor(y)).numpy(),
                               np.asarray(ref.rmatvec(jnp.asarray(y))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port.row_norms_sq.numpy(),
                               np.asarray(ref.row_norms_sq), rtol=1e-14)
    np.testing.assert_allclose(port.col_norms_sq.numpy(),
                               np.asarray(ref.col_norms_sq), rtol=1e-14)


def test_importing_the_kernel_module_builds_nothing():
    """The kernel library is built at the first launch, not at import."""
    assert spmv._kernel_lib.cache_info().currsize == 0


def test_nonfinite_x_at_an_unstored_column():
    """The one deliberate difference from the reference (ROADMAP queue 3):
    the reference's tiles multiply their unstored zeros by x, so a NaN at
    a column that a row does not store reaches that row there; the port
    reads only the stored entries."""
    A = _matrix("17x260")
    x = np.random.default_rng(3).standard_normal(260)
    j = 5
    x[j] = np.nan
    stores = np.isin(np.arange(17), A[:, [j]].nonzero()[0])
    y_ref = np.asarray(j_bcsr_matvec(JBCSR.from_scipy(A, dtype=jnp.float64),
                                     jnp.asarray(x), use_pallas=True,
                                     interpret=True))
    y = spmv.bcsr_matvec(spmv.BCSRMatrix.from_scipy(A, dtype=torch.float64),
                         torch.as_tensor(x)).numpy()
    assert np.isnan(y_ref).all()             # column 5 lies in every tile
    assert np.isnan(y[stores]).all()
    assert np.isfinite(y[~stores]).all() and (~stores).any()
    np.testing.assert_allclose(y[~stores], (A @ np.nan_to_num(x))[~stores],
                               rtol=1e-12, atol=1e-12)
