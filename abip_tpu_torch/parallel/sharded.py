"""The multi-card layer: block-row products, distributed PCG, and lanes
split over a mesh, on `torch.distributed`.

Port of `abip_tpu/parallel/sharded.py` and of the reference's `mesh`
arguments.  The stand-in for a JAX `Mesh` is a 1-D
`torch.distributed.device_mesh.DeviceMesh`; the collectives run on
`mesh.get_group(axis)`, axis "rows" for a row-sharded matrix and
"batch" for the batch drivers, the reference's axis names.

The reference gets its collectives from GSPMD (`shard_map`, or the SPMD
partitioner under `jit`).  PyTorch has no partitioner that covers the
solvers' host loops, so the collectives are written out at the seams
where GSPMD puts them, the products with A:

    A x         = all_gather(A_d x)                (A_d: this rank's rows)
    A' y        = all_reduce(A_d' y_d)             (y_d: the same rows of y)
    A'(w * A x) = all_reduce(A_d'(w_d * A_d x))    (the CG Schur product)

Every call is SPMD: each rank of the mesh makes the same call with the
same full inputs (every device sees the global array in JAX), and each
rank returns the whole result.  Collectives give every rank the same
bits, so every rank computes the same host-side decisions (stop tests,
iteration counts) and no rank can wait alone in a collective.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..problem import LinearOperator


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`: the current CUDA card for a "cuda"
    mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_group(mesh, axis: str, device=None):
    """(process group, this rank's index, size) of the 1-D `mesh` along
    `axis`.  Raises `TypeError` for anything but a `DeviceMesh` and
    `ValueError` for a mesh of more dimensions, without `axis`, or on
    another device type than `device`."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh; got {type(mesh).__name__}")
    if mesh.ndim != 1:
        raise ValueError(f"mesh must be 1-D; got {mesh.ndim} dimensions")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                         f"{mesh.mesh_dim_names}")
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"the mesh runs on {mesh.device_type!r} but the "
                         f"solve on {torch.device(device).type!r}")
    return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size()


def all_gather_rows(part, group, size):
    """The `size` ranks' `part`s stacked along the first axis, in rank
    order, on every rank: one collective into one tensor, no list of
    parts to concatenate."""
    part = part.contiguous()
    out = part.new_empty((size * part.shape[0],) + tuple(part.shape[1:]))
    # PyTorch 2.13 renamed `all_gather_into_tensor` `all_gather_single`
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, part, group=group)
    return out


def all_reduce_sum(t, group):
    """The sum of every rank's `t`, on every rank (in place)."""
    dist.all_reduce(t, group=group)
    return t


def row_sharded_operator(A, group, rank, size) -> LinearOperator:
    """A `LinearOperator` of the dense `(m, n)` A whose rank keeps only
    its block of m/size rows: `matvec` all-gathers the blocks of A x,
    `rmatvec` all-reduces A_d' y_d, and `normal(x, w)` = A'(w * A x)
    all-reduces the sum of A_d'(w_d * A_d x), one collective where the
    two products take two.  All take and return whole (replicated)
    vectors.  `.local` is the block, `.rows` its slice."""
    m, n = A.shape
    mb = m // size
    rows = slice(rank * mb, (rank + 1) * mb)
    A_d = A[rows].contiguous()

    def matvec(x):
        return all_gather_rows(A_d @ x, group, size)

    def rmatvec(y):
        return all_reduce_sum(A_d.T @ y[rows], group)

    def normal(x, w):
        return all_reduce_sum(A_d.T @ (w[rows] * (A_d @ x)), group)

    op = LinearOperator(m, n, matvec, rmatvec)
    op.local, op.rows, op.normal = A_d, rows, normal
    return op


def check_rows(m, size):
    """The reference's refusal of a row count the mesh does not divide
    (`abip_tpu/lp.py:592-596`)."""
    if m % size != 0:
        raise ValueError(f"m={m} must be divisible by the mesh size {size}")


def sharded_normal_matvec(A_local, y_local, rho_y, group):
    """G y = rho_y y + A A' y with A block-row sharded over `group`: this
    rank's rows of G y from its rows A_local of A and y_local of y
    (`abip_tpu/parallel/sharded.py:24-30`)."""
    t = all_reduce_sum(A_local.T @ y_local, group)     # A' y, replicated
    return rho_y * y_local + A_local @ t


def _pdot(a, b, group):
    return all_reduce_sum((a * b).sum(), group)


def sharded_pcg(A_local, b_local, M_local, rho_y, tol, max_iters, group):
    """Jacobi-PCG on (rho_y I + A A') x = b, every operand row-sharded
    (`abip_tpu/parallel/sharded.py:37-77`, the reference's
    `indirect.c:321-391`): each inner product is a local partial plus an
    `all_reduce`.  The loop runs on the host; its stop test reads the
    all-reduced ||r||, the same bits on every rank, so every rank stops
    at the same iteration.  Returns (this rank's rows of x, iterations)
    with the count a Python int."""
    def G(y):
        return sharded_normal_matvec(A_local, y, rho_y, group)

    x = torch.zeros_like(b_local)
    r = b_local - G(x)
    z = M_local * r
    p = z
    ipzr = _pdot(z, r, group)
    i = 0
    while i < max_iters and bool(torch.sqrt(_pdot(r, r, group)) >= tol):
        Gp = G(p)
        a = ipzr / _pdot(p, Gp, group)
        x = x + a * p
        r = r - a * Gp
        z = M_local * r
        new = _pdot(z, r, group)
        p = z + (new / ipzr) * p
        ipzr = new
        i += 1
    return x, i


def make_sharded_kkt_solver(A, rho_y, mesh, axis="rows", tol=1e-9,
                            max_iters=500):
    """A solver of the LP KKT system [[rho_y I, A], [A', -I]] with A
    block-row sharded over the 1-D `mesh` along `axis`
    (`abip_tpu/parallel/sharded.py:80-114`).

    Every rank calls it with the same whole A (a tensor or an array; it
    goes to this rank's device of the mesh) and keeps its rows of A and
    of the Jacobi diagonal 1/(rho_y + rowsum(A*A)).  Returns
    solve(w_y, w_x) -> (z_y, z_x, iters): w_y and w_x whole, the same on
    every rank; z_y all-gathered and z_x all-reduced, whole on every
    rank; iters a Python int."""
    group, rank, size = mesh_group(mesh, axis)
    dev = mesh_device(mesh)
    A = torch.as_tensor(A, device=dev)
    m, n = A.shape
    if m % size != 0:
        raise ValueError(f"m={m} must divide the mesh size {size} "
                         f"(pad rows)")
    mb = m // size
    rows = slice(rank * mb, (rank + 1) * mb)
    A_d = A[rows].contiguous()
    M_d = 1.0 / (rho_y + (A_d * A_d).sum(dim=1))

    def solve(w_y, w_x):
        w_y = torch.as_tensor(w_y, dtype=A.dtype, device=dev)
        w_x = torch.as_tensor(w_x, dtype=A.dtype, device=dev)
        # fold the x part into the y rhs: w_y + A w_x (`indirect.c:415`)
        rhs_d = w_y[rows] + A_d @ w_x
        z_d, iters = sharded_pcg(A_d, rhs_d, M_d, rho_y, tol, max_iters,
                                 group)
        # back-substitute (`indirect.c:419-420`)
        z_x = all_reduce_sum(A_d.T @ z_d, group) - w_x
        return all_gather_rows(z_d, group, size), z_x, iters

    return solve


def lanes_over_mesh(mesh, device, stacks, run):
    """`run(*shares)` on this rank's lanes of the `(B, ...)` `stacks`
    (rank r takes lanes [r B/p, (r+1) B/p) of a mesh of p along
    "batch"), then every lane-first field of the NamedTuple it returns
    all-gathered in lane order; a field that is None stays None.  A B
    the mesh size does not divide raises `ValueError`, as JAX's
    `device_put` does."""
    group, rank, size = mesh_group(mesh, "batch", device)
    B = stacks[0].shape[0]
    if B % size != 0:
        raise ValueError(f"a batch of {B} lanes must be divisible by the "
                         f"mesh size {size}")
    share = B // size
    lanes = slice(rank * share, (rank + 1) * share)
    out = run(*(s[lanes] for s in stacks))
    return type(out)(*(None if f is None else
                       all_gather_rows(f, group, size) for f in out))
