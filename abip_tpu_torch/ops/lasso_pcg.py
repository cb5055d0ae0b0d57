"""The LASSO operator's Schur PCG iteration as two kernels, F1 and F2.

No TPU kernel is ported here: the JAX package runs this PCG as XLA ops.
On `problems.lasso_operator`'s products (A_s = D^-1 A E^-1, A = [[1, 0, 0,
0, 0], [0, 0, I, X, -X]], z = (t1, t2, r, w+, w-)) one iteration of
`linsys.cg`'s PCG on S = A_s'(ry_inv o A_s) + rho_x is

  * F1 (`f1`): one pass over X.  With w = p_w+ / E_w+ - p_w- / E_w-,
    v_i = (ry_inv_1+i ((p_r,i / E_r,i + (X w)_i) / D_1+i)) / D_1+i, and
    each row's v_i X_i,: is added while the row is at hand.  The m rows
    are cut among G clusters of C CTAs (`Plan`, `rows`); each CTA sums its
    rows in order, each cluster its CTAs in rank order into one partial
    row of X'v.  It writes v and the G partial rows.
  * F2 (`f2`): the vector step.  X'v is the partial rows summed in order;
    S p over the five blocks; then alpha, x, r, z = M o r, <z, r>, beta,
    p as `cg._pcg_iteration` takes them; the count; the running flag
    (count < cap and ||r|| >= tol) of the next iteration; and its w.

The loop's state is on the device: `flag` = [running, count] (int64), the
block graph's flag.  Each function first reads it and changes nothing
where the loop has stopped, so a block of iterations stops where `cg.pcg`
would.  `Iteration` holds F1's buffers and runs the two in turn:
`problems.lasso_operator` hands the class to its operator
(`pcg_iteration`), and `linsys.schur`'s block graph runs it there in
place of `cg.pcg_block`.  On CUDA tensors each function launches its kernel of
`csrc/lasso_pcg.cu` (built and loaded at its first call); on CPU tensors
it runs its plain version (`f1_plain`, `f2_plain`), the kernels' algebra
in the same partition and order of sums.  Nothing is compiled when this
module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.graphs import count_launch

THREADS = 1024      # a CTA of either kernel
MAX_COLS = 8        # columns an F1 thread holds in registers
CLUSTER = 8         # CTAs of an F1 cluster, and of F2's at most (portable)
ROWS_MIN = 4        # rows a CTA takes at least before F1 adds a cluster
H100_ACTIVE = 15    # F1 clusters an H100 80GB HBM3 holds at once (n = 5000)


class Plan(NamedTuple):
    """F1 on `clusters` clusters of `cluster` CTAs over X of shape (m, n);
    F2 on one cluster of `f2_cluster` CTAs, a thread for each pair (w+_j,
    w-_j) and each entry of (t1, t2, r)."""
    m: int
    n: int
    clusters: int
    cluster: int
    f2_cluster: int


def fits(m: int, n: int) -> bool:
    """Whether the kernels hold X of shape (m, n): n + 2 + m units in the
    threads of F2's one cluster of at most CLUSTER CTAs (then n columns
    take at most MAX_COLS an F1 thread, and F1's shared memory, w and a
    cluster's rows' scalars, holds too)."""
    return 1 <= m and 1 <= n and n + 2 + m <= CLUSTER * THREADS


def plan(m: int, n: int, active: int) -> Plan:
    """The plan of shape (m, n) on a card that holds `active` F1 clusters
    at once: as many clusters as it holds, fewer where a CTA would get
    fewer than ROWS_MIN rows; F2's cluster as small as holds its units."""
    if not fits(m, n):
        raise ValueError(f"the kernels do not hold X of shape ({m}, {n})")
    return Plan(m, n, max(1, min(active, m // (CLUSTER * ROWS_MIN))),
                CLUSTER, -(-(n + 2 + m) // THREADS))


def rows(pl: Plan):
    """[(first, end)] of the rows each F1 CTA b = g C + rank holds."""
    B = pl.clusters * pl.cluster
    return [(b * pl.m // B, (b + 1) * pl.m // B) for b in range(B)]


def _stopped(flag) -> bool:
    return not int(flag[0])


def w_of(pl: Plan, p, E):
    """F1's w from p: p_w+ / E_w+ - p_w- / E_w-."""
    h, n = 2 + pl.m, pl.n
    return p[h:h + n] / E[h:h + n] - p[h + n:] / E[h + n:]


def f1_plain(pl: Plan, X, D, E, ry_inv, p, w, flag, v, partials):
    """F1 on CPU tensors: v and the partial rows of X'v, each CTA's rows
    summed in order, each cluster's CTAs in rank order."""
    if _stopped(flag):
        return
    m = pl.m
    pe = p[2:2 + m] / E[2:2 + m]
    vv = (ry_inv[1:] * ((pe + X @ w) / D[1:])) / D[1:]
    v.copy_(vv)
    spans = rows(pl)
    for g in range(pl.clusters):
        total = torch.zeros_like(w)
        for first, end in spans[g * pl.cluster:(g + 1) * pl.cluster]:
            # the CTA's rows added one after another (a running sum)
            terms = vv[first:end, None] * X[first:end]
            total = total + (terms.cumsum(0)[-1] if end > first
                             else torch.zeros_like(w))
        partials[g].copy_(total)


def f2_plain(pl: Plan, partials, v, D, E, ry_inv, rho_x, M, tol, cap, x, r,
             p, w, ipzr, flag):
    """F2 on CPU tensors: X'v from the partial rows in order, S p, one
    step of `cg._pcg_iteration`, the count, the next running flag and
    w."""
    if _stopped(flag):
        return
    xt = torch.zeros_like(w)
    for c in range(pl.clusters):
        xt = xt + partials[c]
    u0 = (ry_inv[:1] * ((p[:1] / E[:1]) / D[:1])) / D[:1]
    s = torch.cat([u0, torch.zeros_like(u0), v, xt, -xt]) / E + rho_x * p
    alpha = ipzr / (p * s).sum()
    r_n = r - alpha * s
    z = M * r_n
    zr, rr = (z * r_n).sum(), (r_n * r_n).sum()
    p_n = z + (zr / ipzr) * p
    x.copy_(x + alpha * p)
    r.copy_(r_n)
    p.copy_(p_n)
    w.copy_(w_of(pl, p_n, E))
    its = flag[1] + 1
    flag.copy_(torch.stack([((its < cap) & (torch.sqrt(rr) >= tol)).long(),
                            its]))
    ipzr.copy_(zr)


@functools.lru_cache(maxsize=None)
def _lib():
    from .build import load

    lib = load("lasso_pcg").lib
    lib.abip_lasso_pcg_prepare.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.abip_lasso_pcg_f1.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.abip_lasso_pcg_f2.argtypes = [ctypes.c_void_p] * 15 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.abip_lasso_pcg_prepare, lib.abip_lasso_pcg_f1,
               lib.abip_lasso_pcg_f2):
        fn.restype = ctypes.c_int
    lib.abip_cuda_error_string.argtypes = [ctypes.c_int]
    lib.abip_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(err, what):
    if err:
        raise RuntimeError(f"{what} failed: "
                           + _lib().abip_cuda_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _active(device_index: int, m: int, n: int) -> int:
    """F1 clusters of shape (m, n) the card holds at once; lets the
    kernels take their shared memory and cluster size first (never
    inside a capture)."""
    out = ctypes.c_int()
    with torch.cuda.device(device_index):
        _check(_lib().abip_lasso_pcg_prepare(m, n, CLUSTER,
                                             ctypes.byref(out)),
               "lasso_pcg prepare")
    if out.value < 1:
        raise RuntimeError(f"the card holds no F1 cluster of shape ({m}, {n})")
    return out.value


def card_plan(m: int, n: int, device) -> Plan:
    """The plan of shape (m, n) on the CUDA card `device`, from its
    occupancy; builds and loads the kernels at the first call."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return plan(m, n, _active(index, m, n))


def _need(tensors, dtype, device):
    for name, t in tensors.items():
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"operand {name}: need contiguous {dtype} on "
                             f"{device}; got {t.dtype} on {t.device}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def f1_cuda(pl: Plan, X, D, E, ry_inv, p, w, flag, v, partials):
    """One launch of F1 on CUDA tensors (f64; flag int64)."""
    dev = X.device
    _need(dict(X=X, D=D, E=E, ry_inv=ry_inv, p=p, w=w, v=v,
               partials=partials), torch.float64, dev)
    _need(dict(flag=flag), torch.int64, dev)
    if X.shape != (pl.m, pl.n) or partials.shape != (pl.clusters, pl.n):
        raise ValueError(f"X {tuple(X.shape)} and partials "
                         f"{tuple(partials.shape)} do not fit {pl}")
    with torch.cuda.device(dev):
        _check(_lib().abip_lasso_pcg_f1(
            X.data_ptr(), D.data_ptr(), E.data_ptr(), ry_inv.data_ptr(),
            p.data_ptr(), w.data_ptr(), flag.data_ptr(), v.data_ptr(),
            partials.data_ptr(), pl.m, pl.n, pl.clusters, pl.cluster,
            _stream(dev)), "lasso_pcg F1 launch")
    count_launch(f1_cuda)


def f2_cuda(pl: Plan, partials, v, D, E, ry_inv, rho_x, M, tol, cap, x, r,
            p, w, ipzr, flag):
    """One launch of F2 on CUDA tensors (f64; cap and flag int64)."""
    dev = x.device
    _need(dict(partials=partials, v=v, D=D, E=E, ry_inv=ry_inv, rho_x=rho_x,
               M=M, tol=tol, x=x, r=r, p=p, w=w, ipzr=ipzr),
          torch.float64, dev)
    _need(dict(cap=cap, flag=flag), torch.int64, dev)
    if x.numel() != 2 + pl.m + 2 * pl.n:
        raise ValueError(f"x of {x.numel()} entries does not fit {pl}")
    with torch.cuda.device(dev):
        _check(_lib().abip_lasso_pcg_f2(
            partials.data_ptr(), v.data_ptr(), D.data_ptr(), E.data_ptr(),
            ry_inv.data_ptr(), rho_x.data_ptr(), M.data_ptr(),
            tol.data_ptr(), cap.data_ptr(), x.data_ptr(), r.data_ptr(),
            p.data_ptr(), w.data_ptr(), ipzr.data_ptr(),
            flag.data_ptr(), pl.m, pl.n, pl.clusters, pl.f2_cluster,
            _stream(dev)), "lasso_pcg F2 launch")
    count_launch(f2_cuda)


f1_cuda.launches = 0
f2_cuda.launches = 0


def f1(pl: Plan, *args):
    """F1: the kernel on CUDA tensors, the plain version on CPU ones."""
    return (f1_cuda if args[0].is_cuda else f1_plain)(pl, *args)


def f2(pl: Plan, *args):
    """F2: the kernel on CUDA tensors, the plain version on CPU ones."""
    return (f2_cuda if args[0].is_cuda else f2_plain)(pl, *args)


class Iteration:
    """The Schur PCG's iteration on the LASSO operator as F1 then F2, over
    the operator's operands {X, D, E}, with F1's w, v and partial rows.
    The plan is the card's on CUDA operands; off a card the rows are cut
    as on an H100."""

    @staticmethod
    def holds(operands) -> bool:
        """Whether the kernels hold the operator's X."""
        return fits(*operands["X"].shape)

    def __init__(self, operands):
        X = operands["X"]
        m, n = X.shape
        self.ops = operands
        self.plan = (card_plan(m, n, X.device) if X.is_cuda
                     else plan(m, n, H100_ACTIVE))
        self.w = X.new_empty((n,))
        self.v = X.new_empty((m,))
        self.partials = X.new_empty((self.plan.clusters, n))

    def start(self, p):
        """F1's first w, from the start state's p."""
        self.w.copy_(w_of(self.plan, p, self.ops["E"]))

    def __call__(self, ry_inv, rho_x, M, tol, cap, x, r, p, ipzr, flag):
        """One iteration: x, r, p, <z, r> and flag = [running, count] in
        place, unchanged where flag says the loop has stopped."""
        o, pl = self.ops, self.plan
        f1(pl, o["X"], o["D"], o["E"], ry_inv, p, self.w, flag, self.v,
           self.partials)
        f2(pl, self.partials, self.v, o["D"], o["E"], ry_inv, rho_x, M, tol,
           cap, x, r, p, self.w, ipzr, flag)
