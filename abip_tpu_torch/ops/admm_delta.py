"""Anchored-delta ADMM chunk: f64-quality iterates from f32 iterations.

Port of `abip_tpu/ops/admm_delta.py`.  A chunk iterates DELTAS from an
f64 anchor entirely in f32: every quantity the iteration touches is the
distance from the chunk-entry iterate, so f32's relative error becomes a
tiny absolute error.  The anchor images (one absolute ADMM step, prox
anchors, residual anchors) are computed once per chunk in f64 by
`delta_anchor`; the per-iteration work is `_delta_compute` (the plain
PyTorch version) or the CUDA kernel `csrc/admm_delta.cu`, which runs
each lane as one thread-block cluster (`delta_launch_plan`).

Numerical hygiene, as in the reference (each is load-bearing):

* The barrier prox delta uses the cancellation-free identity
  prox(t) = (t + s)/2 = 2*lam/(s - t),  s = sqrt(t^2 + 4 lam)
  (`_prox_delta`), so every factor is accurate relative to the delta.
* t0 is rounded to f32 and the rounding residue is folded into the
  offset et := (rel_x0 - vx0) - f32(t0); s0 and prox(t0) are computed
  in f64 from the rounded t0.
* The inner criterion is probed every `probe` iterations in the delta
  frame, on the current and on the stage-averaged iterate; prior-chunk
  history enters the average through c0 := S_prev - sj_prev * anchor.

Layout: the lane axis comes first.  Rows are `(B, m)` or `(B, n)` f32
tensors, `A` is `(B, m, n)`, `Ninv` is `(B, m, m)`, and the per-lane
scalars are one `(B, 20)` f32 tensor with the reference's slot order.
There is no 128-padding; zero padding, where a caller brings it (see
`anchor_from_numpy`), stays inert because pads carry t0 = 0 and
s0 = 2 sqrt(lam).

Reference hot loop: `src/abip-lp/src/abip.c:2131-2215`.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..device import smem_optin
from ..utils.profiling import annotate

f32 = torch.float32
f64 = torch.float64


class DeltaAnchor(NamedTuple):
    """f32 operands of one delta chunk, lane axis first."""

    scal: torch.Tensor    # (B, 20) per-lane scalars, slots below
    A: torch.Tensor       # (B, m, n)
    Ninv: torch.Tensor    # (B, m, m)
    hy: torch.Tensor
    hx: torch.Tensor
    gy: torch.Tensor
    gx: torch.Tensor
    maskx: torch.Tensor
    ey: torch.Tensor      # F(anchor)-anchor, y block
    ex: torch.Tensor      # prox(t0)-x0
    evx: torch.Tensor     # x0 - rel_x0
    t0x: torch.Tensor     # f32 prox-argument anchor
    sax: torch.Tensor     # sqrt(t0x^2 + 4 lam), f64-computed from f32 t0x
    etx: torch.Tensor     # (rel_x0 - vx0) - t0x rounding residue
    q1_0: torch.Tensor    # qres anchor: A x0 + tau0 hy
    q2_0: torch.Tensor    # qres anchor: (A'y0 + vx0 - tau0 hx) mask
    y0: torch.Tensor      # anchor values (norm cross-terms)
    x0: torch.Tensor
    vx0: torch.Tensor
    c0y: torch.Tensor     # prior-chunk average history: S_prev - sj*anchor
    c0x: torch.Tensor
    c0vx: torch.Tensor


# scal slots (the reference's packed scalar row, first 20 columns)
(_S_RHOY, _S_IGTH, _S_LAM, _S_ALPHA, _S_THRESH, _S_TAU0, _S_KAPPA0,
 _S_T0T, _S_SAT, _S_ETT, _S_ETAU, _S_EVTAU, _S_Q30, _S_UN0, _S_VN0,
 _S_SJ, _S_C0TAU, _S_C0KAP, _S_QINIT, _S_EYTAU) = range(20)
N_SCAL = 20
# output row: [dtau, dkappa, dstau, dskappa, qres, t_done, avg_crit]
ROW_WIDTH = 7
_M_FIELDS = ("hy", "gy", "ey", "q1_0", "y0", "c0y")


def _mv(M, x):
    """(B, r, k) x (B, k) -> (B, r)."""
    return torch.matmul(M, x.unsqueeze(-1)).squeeze(-1)


def _rmv(M, y):
    """(B, r, k)' x (B, r) -> (B, k)."""
    return torch.matmul(y.unsqueeze(-2), M).squeeze(-2)


def _prox_delta(dt, t0, s0, lam):
    """prox(t0 + dt, lam) - prox(t0, lam), cancellation-free.

    s0 = sqrt(t0^2 + 4 lam) must be consistent with t0 (computed in f64
    from the f32 t0).  The branch follows the CURRENT argument's sign;
    lam > 0 keeps every denominator >= 2*sqrt(lam) > 0."""
    t = t0 + dt
    s = torch.sqrt(t * t + 4.0 * lam)
    ds = dt * (t0 + t) / (s + s0)
    pos = 0.5 * (dt + ds)
    neg = 2.0 * lam * (dt - ds) / ((s - t) * (s0 - t0))
    return torch.where(t >= 0, pos, neg)


def _delta_compute(anc: DeltaAnchor, t_max, probe):
    """The plain PyTorch version of the chunk kernel.

    Lane b runs trips of `probe` iterations while `t < t_max[b]` and
    `qres >= thresh`; a lane that has stopped is frozen by mask.  Returns
    (dy, dx, dvx, dsy, dsx, dsvx, row): final deltas, delta sums over
    the executed iterations, and a `(B, 7)` row
    [dtau, dkappa, dstau, dskappa, qres, t_done, avg_crit].  It runs in
    the anchor's dtype: f32 as the kernel does, or f64 to measure the
    f32 versions' own error."""
    if anc.A.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the delta chunk needs IEEE f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    A, Ninv, sc = anc.A, anc.Ninv, anc.scal

    def col(k):
        return sc[:, k:k + 1]

    rho_y, inv_gth1, lam = col(_S_RHOY), col(_S_IGTH), col(_S_LAM)
    alpha, thresh = col(_S_ALPHA), col(_S_THRESH)
    tau0, kappa0 = col(_S_TAU0), col(_S_KAPPA0)
    t0t, sat, ett = col(_S_T0T), col(_S_SAT), col(_S_ETT)
    etau, evtau, q3_0 = col(_S_ETAU), col(_S_EVTAU), col(_S_Q30)
    un0, vn0, sj_prev = col(_S_UN0), col(_S_VN0), col(_S_SJ)
    c0tau, c0kap = col(_S_C0TAU), col(_S_C0KAP)
    hy, hx, gy, gx, maskx = anc.hy, anc.hx, anc.gy, anc.gx, anc.maskx

    def bsum(x):
        return x.sum(-1, keepdim=True)

    def iter_body(dy, dx, dvx, dtau, dkap, dsy, dsx, dsvx, dstau, dskap):
        # linear projection pipeline on deltas (exact: same operators)
        drtau = dtau + dkap
        dqy = rho_y * dy - drtau * hy
        dqx = (dx + dvx) - drtau * hx
        dcoef = (bsum(dqy * gy) + bsum(dqx * gx)) * inv_gth1
        dqy = dqy - dcoef * hy
        dqx = dqx - dcoef * hx
        dwx = -dqx
        drhs = dqy + _mv(A, dwx)
        dz_y = _mv(Ninv, drhs)
        dz_x = _rmv(A, dz_y) - dwx
        dtau_t = drtau + bsum(dz_y * hy) + bsum(dz_x * hx)
        dy_n = anc.ey + dz_y
        drel_x = alpha * dz_x + (1.0 - alpha) * dx
        dtx = drel_x - dvx + anc.etx
        px = _prox_delta(dtx, anc.t0x, anc.sax, lam) * maskx
        dx_n = anc.ex + px
        dvx_n = dvx + dx_n - drel_x + anc.evx
        drel_t = alpha * dtau_t + (1.0 - alpha) * dtau
        dtt = drel_t - dkap + ett
        dtau_n = etau + _prox_delta(dtt, t0t, sat, lam)
        dkap_n = dkap + dtau_n - drel_t + evtau
        return (dy_n, dx_n, dvx_n, dtau_n, dkap_n,
                dsy + dy_n, dsx + dx_n, dsvx + dvx_n,
                dstau + dtau_n, dskap + dkap_n)

    def qres_delta(dy, dx, dvx, dtau, dkap):
        """HSD-operator residual at anchor + delta (`abip.c:1951-1996`)."""
        q1 = anc.q1_0 + _mv(A, dx) + dtau * hy
        q2 = anc.q2_0 + (_rmv(A, dy) + dvx - dtau * hx) * maskx
        q3 = q3_0 - bsum(dy * hy) - bsum(dx * hx) - dkap
        qsq = bsum(q1 * q1) + bsum(q2 * q2) + q3 * q3
        un = (un0 + 2.0 * (bsum(anc.y0 * dy) + bsum(anc.x0 * dx)
                           + tau0 * dtau)
              + bsum(dy * dy) + bsum(dx * dx) + dtau * dtau)
        vn = (vn0 + 2.0 * (bsum(anc.vx0 * dvx) + kappa0 * dkap)
              + bsum(dvx * dvx) + dkap * dkap)
        denom = 1.0 + torch.sqrt(torch.clamp(un + vn, min=0.0))
        return torch.sqrt(qsq) / denom

    B, dt = A.shape[0], A.dtype
    zy = torch.zeros_like(anc.ey)
    zx = torch.zeros_like(anc.ex)
    zs = torch.zeros((B, 1), dtype=dt, device=A.device)
    state = (zy, zx, zx, zs, zs, zy, zx, zx, zs, zs)
    t = torch.zeros((B, 1), dtype=torch.int32, device=A.device)
    t_max = t_max.to(device=A.device, dtype=torch.int32).reshape(B, 1)
    q = col(_S_QINIT).clone()
    avg_crit = torch.zeros((B, 1), dtype=dt, device=A.device)
    while True:
        run = (t < t_max) & (q >= thresh)
        if not bool(run.any()):
            break
        new = state
        for _ in range(probe):
            new = iter_body(*new)
        t_new = t + probe
        dom = torch.clamp(sj_prev + t_new.to(dt), min=1.0)
        dy, dx, dvx, dtau, dkap, dsy, dsx, dsvx, dstau, dskap = new
        q_cur = qres_delta(dy, dx, dvx, dtau, dkap)
        q_avg = qres_delta((anc.c0y + dsy) / dom, (anc.c0x + dsx) / dom,
                           (anc.c0vx + dsvx) / dom, (c0tau + dstau) / dom,
                           (c0kap + dskap) / dom)
        state = tuple(torch.where(run, a, b) for a, b in zip(new, state))
        t = torch.where(run, t_new, t)
        q = torch.where(run, torch.minimum(q_avg, q_cur), q)
        avg_crit = torch.where(run, (q_avg < q_cur).to(dt), avg_crit)
    dy, dx, dvx, dtau, dkap, dsy, dsx, dsvx, dstau, dskap = state
    row = torch.cat([dtau, dkap, dstau, dskap, q, t.to(dt), avg_crit], dim=1)
    return dy, dx, dvx, dsy, dsx, dsvx, row


# The kernel's launch: one cluster of C CTAs per lane, 512 threads a CTA.
# CLUSTER is the size measured fastest at the smoke shape (PERF.md: an
# H100 SXM holds 17 such clusters at once, all 16 lanes of a tile, but
# only 15 of 8); 16 is the largest a Hopper card allows (8 is the
# portable limit).
CLUSTER = 6
CLUSTER_MAX = 16
THREADS = 512
# shared memory an H100 gives one block (`sharedMemPerBlockOptin`)
SMEM_OPTIN = 232_448
# floats of every CTA's reduction scratch (16 warps x 12), its two scalar
# slots and the exchanged sums (16 each)
_SCRATCH_FLOATS = (THREADS // 32) * 12 + 3 * 16
# x-side slices a resident CTA holds: 13 operands and 4 state vectors
_X_SLICES = 17
# m-side vectors outside the exchange buffers: in shared memory where
# resident, else in a global workspace of this many m-vectors per CTA
_M_VECS = 5


class DeltaPlan(NamedTuple):
    """How one chunk of a cluster kernel (K1 here, K6 and K7 in
    `ops/admm_sprint.py`, K3 in `ops/conic_delta.py`) launches:
    `cluster` CTAs per lane; `resident`: A's column slice, Ninv and the
    x-side slices live in each CTA's shared memory (else they are read
    through L2); `smem_bytes` per CTA; `spill`: the streaming form with
    its shared-memory layout (the exchange buffers included) in a global
    workspace, for shapes whose CTA no shared memory holds
    (`smem_bytes` 0)."""

    cluster: int
    resident: bool
    smem_bytes: int
    spill: bool = False


def delta_cols_per_cta(n, cluster):
    """Columns each CTA of a lane owns: ceil(n / cluster) rounded up to a
    multiple of 4 (the kernel reads resident rows as 16-byte vectors)."""
    return -(-(-(-n // cluster)) // 4) * 4


def cluster_smem_bytes(m, n, cluster, resident, x_slices, m_vecs):
    """Dynamic shared memory of one CTA of the LP cluster kernels
    (`csrc/admm_delta.cu:smem_floats`, `csrc/admm_sprint.cu`): two
    exchange buffers of 2 m, the reduction scratch, the row dots' x
    operand (nc = `delta_cols_per_cta`), and where resident the
    `m_vecs` m-side vectors, A's slice (m nc), Ninv (m^2) and the
    `x_slices` x-side slices."""
    nc = delta_cols_per_cta(n, cluster)
    floats = 4 * m + _SCRATCH_FLOATS + nc
    if resident:
        floats += m_vecs * m + m * nc + m * m + x_slices * nc
    return 4 * floats


def cluster_plan(m, n, smem_limit, x_slices, m_vecs, cluster=CLUSTER):
    """The launch of an LP cluster kernel at shape (m, n): clusters of
    `cluster` CTAs, resident if that fits `smem_limit`, else streaming
    A, Ninv and the x-side operands through L2, else spilled (the
    streaming form with its layout in global memory), which takes every
    shape."""
    if m < 1 or n < 1:
        raise ValueError(f"empty chunk: m={m} n={n}")
    for resident in (True, False):
        nbytes = cluster_smem_bytes(m, n, cluster, resident, x_slices, m_vecs)
        if nbytes <= smem_limit:
            return DeltaPlan(cluster, resident, nbytes)
    return DeltaPlan(cluster, False, 0, spill=True)


def delta_smem_bytes(m, n, cluster, resident):
    """Dynamic shared memory of one CTA of K1 (`cluster_smem_bytes` with
    its 17 x-side slices and 5 m-side vectors)."""
    return cluster_smem_bytes(m, n, cluster, resident, _X_SLICES, _M_VECS)


def delta_launch_plan(m, n, smem_limit=SMEM_OPTIN):
    """The launch of a chunk of shape (m, n): clusters of CLUSTER CTAs,
    resident if that fits `smem_limit`, else streaming A, Ninv and the
    x-side operands through L2 (it needs less than one block per lane
    needed: n + 5 m floats and the scratch), else spilled.  Where the
    reference runs its XLA chunk because its kernel does not fit VMEM,
    the port's kernel spills."""
    return cluster_plan(m, n, smem_limit, _X_SLICES, _M_VECS)


def check_plan(plan: DeltaPlan, limit):
    """Raise unless the card can take `plan`: 1-CLUSTER_MAX CTAs, and the
    shared memory of a CTA within `limit`."""
    if not 1 <= plan.cluster <= CLUSTER_MAX or plan.smem_bytes > limit or (
            plan.spill and (plan.resident or plan.smem_bytes)):
        raise ValueError(f"plan {plan} outside clusters of 1-{CLUSTER_MAX} "
                         f"CTAs and {limit} B of shared memory")


def cluster_workspace(lib_fn, B, plan: DeltaPlan, dev, *shape):
    """The global workspace of a streaming or spilled launch
    (`lib_fn(*shape, cluster, spill)` floats per CTA), or None."""
    if plan.resident:
        return None
    per_cta = lib_fn(*shape, plan.cluster, int(plan.spill))
    return torch.empty((B * plan.cluster * per_cta,), dtype=f32, device=dev)


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from .build import load

    lib = load("admm_delta").lib
    lib.abip_delta_chunk.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.abip_delta_chunk.restype = ctypes.c_int
    lib.abip_delta_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.abip_delta_smem_bytes.restype = ctypes.c_longlong
    lib.abip_delta_work_floats.argtypes = [ctypes.c_int] * 4
    lib.abip_delta_work_floats.restype = ctypes.c_longlong
    lib.abip_delta_max_active_clusters.argtypes = [
        ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.abip_delta_max_active_clusters.restype = ctypes.c_int
    for fn in (lib.abip_delta_row_width, lib.abip_delta_threads):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.abip_cuda_error_string.argtypes = [ctypes.c_int]
    lib.abip_cuda_error_string.restype = ctypes.c_char_p
    if lib.abip_delta_row_width() != ROW_WIDTH:
        raise RuntimeError("csrc/admm_delta.cu and its wrapper disagree on "
                           "the output row width")
    if (lib.abip_delta_threads() != THREADS
            or lib.abip_delta_work_floats(4, 1, 1, 0) != 4 * _M_VECS):
        raise RuntimeError("csrc/admm_delta.cu and its wrapper disagree on "
                           "the threads or the workspace per CTA")
    return lib


def _cuda_error(lib, what, err):
    return RuntimeError(f"{what}: " + lib.abip_cuda_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def delta_max_active_clusters(m, n, plan: DeltaPlan, device_index=0):
    """How many of the plan's clusters the card holds at once
    (`cudaOccupancyMaxActiveClusters` for its cluster size and shared
    memory).  A lane is one cluster; more lanes than this queue."""
    lib = _kernel_lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.abip_delta_max_active_clusters(
            m, n, plan.cluster, int(plan.resident), int(plan.spill),
            ctypes.byref(out))
    if err:
        raise _cuda_error(lib, "admm_delta occupancy query failed", err)
    return out.value


def delta_chunk_cuda(anc: DeltaAnchor, t_max, probe, plan=None):
    """The chunk on the card: one launch of `csrc/admm_delta.cu`, one
    thread-block cluster per lane, by `delta_launch_plan`.  Same contract
    as `_delta_compute`.  `plan` replaces the launch plan, to time other
    cluster sizes and check other forms; the solvers never pass it.
    Raises on an operand the kernel does not take, on a plan the card
    cannot hold and on a refused launch; never falls back."""
    B, m, n = anc.A.shape
    dev = anc.A.device
    if dev.type != "cuda":
        raise ValueError(f"delta_chunk_cuda needs CUDA tensors; got {dev}")
    if B < 1 or m < 1 or n < 1 or probe < 1:
        raise ValueError(f"empty chunk: B={B} m={m} n={n} probe={probe}")
    want = {"scal": (B, N_SCAL), "A": (B, m, n), "Ninv": (B, m, m)}
    for name, x in anc._asdict().items():
        shape = want.get(name, (B, m if name in _M_FIELDS else n))
        if (x.device != dev or x.dtype != f32 or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(
                f"operand {name}: need contiguous f32 {shape} on {dev}; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    t_max = t_max.to(device=dev, dtype=torch.int32).contiguous()
    if tuple(t_max.shape) != (B,):
        raise ValueError(f"t_max must be ({B},); got {tuple(t_max.shape)}")
    limit = smem_optin(dev)
    if plan is None:
        plan = delta_launch_plan(m, n, limit)
    check_plan(plan, limit)
    lib = _kernel_lib()
    if lib.abip_delta_smem_bytes(m, n, plan.cluster, int(plan.resident),
                                 int(plan.spill)) != plan.smem_bytes:
        raise RuntimeError("csrc/admm_delta.cu and its wrapper disagree on "
                           "the shared memory of a CTA")
    if delta_max_active_clusters(m, n, plan, dev.index or 0) < 1:
        raise RuntimeError(
            f"the card cannot hold one cluster of {plan.cluster} CTAs with "
            f"{plan.smem_bytes} B of shared memory each (m={m} n={n})")
    outs = [torch.empty((B, k), dtype=f32, device=dev)
            for k in (m, n, n, m, n, n, ROW_WIDTH)]
    ins = (ctypes.c_void_p * (len(anc) + 1))(
        *[x.data_ptr() for x in anc], t_max.data_ptr())
    outp = (ctypes.c_void_p * len(outs))(*[x.data_ptr() for x in outs])
    # the streaming form keeps each CTA's m-side vectors in global
    # memory, the spilled form its whole layout
    work = cluster_workspace(lib.abip_delta_work_floats, B, plan, dev, m, n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abip_delta_chunk(
            ins, outp, None if work is None else work.data_ptr(), B, m, n,
            probe, plan.cluster, int(plan.resident), int(plan.spill),
            ctypes.c_void_p(stream))
    if err:
        raise _cuda_error(lib, "admm_delta kernel launch failed", err)
    with _LAUNCHES_LOCK:   # pool threads launch concurrently
        delta_chunk_cuda.launches += 1
    return tuple(outs)


delta_chunk_cuda.launches = 0
_LAUNCHES_LOCK = threading.Lock()


def _per_lane(x, B, like):
    """A float or a `(B,)` tensor as a `(B,)` f64 tensor on `like`'s device."""
    return torch.as_tensor(x, dtype=f64, device=like.device).expand(B)


def delta_anchor(A64, solve64, h, g, g_th, rho_y, lam, alpha, thresh,
                 u, v, u_sum, v_sum, sj, qres, A32=None,
                 Ninv32=None) -> DeltaAnchor:
    """Build the f32 operand set of one delta chunk from the f64 entry
    state, for every lane.  The anchor frame is the exact f64 entry
    state; the one cancellation-sensitive anchor value, the prox
    argument t0, is f32-rounded with its residue folded into et.

    A64 `(B, m, n)`; h, g `(B, m + n)`; g_th `(B,)`; u, v, u_sum, v_sum
    `(B, m + n + 1)` f64; sj `(B,)` int; lam, thresh, qres floats or
    `(B,)`.  solve64(rhs) applies (rho_y I + A A')^-1 in f64 to a
    `(B, m)` vector or a `(B, m, m)` matrix.  A32/Ninv32: the
    loop-invariant f32 operator blocks, when the caller holds them."""
    B, m, n = A64.shape
    lam = _per_lane(lam, B, u)
    thresh = _per_lane(thresh, B, u)
    qres = _per_lane(qres, B, u)
    sjf = sj.to(f64)

    hy64, hx64 = h[:, :m], h[:, m:m + n]
    y0, x0, tau0 = u[:, :m], u[:, m:m + n], u[:, m + n]
    vy0, vx0, kap0 = v[:, :m], v[:, m:m + n], v[:, m + n]
    # one absolute ADMM step at the anchor, in f64 (`abip.c:539-584`)
    r_y = y0 + vy0
    r_x = x0 + vx0
    r_t = (tau0 + kap0)[:, None]
    qy = rho_y * r_y - r_t * hy64
    qx = r_x - r_t * hx64
    coef = (((qy * g[:, :m]).sum(-1) + (qx * g[:, m:m + n]).sum(-1))
            / (g_th + 1.0))[:, None]
    qy = qy - coef * hy64
    qx = qx - coef * hx64
    wx = -qx
    z_y = solve64(qy + _mv(A64, wx))
    z_x = _rmv(A64, z_y) - wx
    tau_t = r_t[:, 0] + (z_y * hy64).sum(-1) + (z_x * hx64).sum(-1)
    ey = z_y - vy0 - y0
    rel_x0 = alpha * z_x + (1.0 - alpha) * x0
    rel_t0 = alpha * tau_t + (1.0 - alpha) * tau0
    # prox anchors: t0 rounded to the f32 the kernel holds, residue into
    # et; s0/prox(t0) computed in f64 FROM the rounded t0 (consistency)
    lamc = lam[:, None]
    t0x_32 = (rel_x0 - vx0).to(f32)
    etx = (rel_x0 - vx0) - t0x_32.to(f64)
    t0x64 = t0x_32.to(f64)
    sax64 = torch.sqrt(t0x64 * t0x64 + 4.0 * lamc)
    xa = torch.where(t0x64 >= 0, 0.5 * (t0x64 + sax64),
                     2.0 * lamc / (sax64 - t0x64))
    ex = xa - x0
    evx = x0 - rel_x0
    t0t_32 = (rel_t0 - kap0).to(f32)
    ett = (rel_t0 - kap0) - t0t_32.to(f64)
    t0t64 = t0t_32.to(f64)
    sat = torch.sqrt(t0t64 * t0t64 + 4.0 * lam)
    taua = torch.where(t0t64 >= 0, 0.5 * (t0t64 + sat),
                       2.0 * lam / (sat - t0t64))
    etau = taua - tau0
    evtau = tau0 - rel_t0
    # qres anchors (`abip.c:1951-1996`; h = (-b; c))
    q1_0 = _mv(A64, x0) + tau0[:, None] * hy64
    q2_0 = _rmv(A64, y0) + vx0 - tau0[:, None] * hx64
    q3_0 = -(y0 * hy64).sum(-1) - (x0 * hx64).sum(-1) - kap0
    un0 = (y0 * y0).sum(-1) + (x0 * x0).sum(-1) + tau0 * tau0
    vn0 = (vy0 * vy0).sum(-1) + (vx0 * vx0).sum(-1) + kap0 * kap0
    # average history in the anchor frame
    c0y = u_sum[:, :m] - sjf[:, None] * y0
    c0x = u_sum[:, m:m + n] - sjf[:, None] * x0
    c0vx = v_sum[:, m:m + n] - sjf[:, None] * vx0
    c0tau = u_sum[:, m + n] - sjf * tau0
    c0kap = v_sum[:, m + n] - sjf * kap0

    scal = torch.stack([
        _per_lane(rho_y, B, u), 1.0 / (g_th + 1.0), lam,
        _per_lane(alpha, B, u), thresh, tau0, kap0, t0t64, sat, ett, etau,
        evtau, q3_0, un0, vn0, sjf, c0tau, c0kap, qres,
        torch.zeros_like(lam)], dim=1).to(f32)

    if A32 is None:
        A32 = A64.to(f32)
    if Ninv32 is None:
        eye = torch.eye(m, dtype=f64, device=A64.device).expand(B, m, m)
        Ninv32 = solve64(eye).to(f32)

    def row(x):
        return x.to(f32).contiguous()

    return DeltaAnchor(
        scal=scal, A=A32.contiguous(), Ninv=Ninv32.contiguous(),
        hy=row(hy64), hx=row(hx64), gy=row(g[:, :m]), gx=row(g[:, m:m + n]),
        maskx=torch.ones((B, n), dtype=f32, device=A64.device),
        ey=row(ey), ex=row(ex), evx=row(evx), t0x=t0x_32.contiguous(),
        sax=row(sax64), etx=row(etx), q1_0=row(q1_0), q2_0=row(q2_0),
        y0=row(y0), x0=row(x0), vx0=row(vx0),
        c0y=row(c0y), c0x=row(c0x), c0vx=row(c0vx))


def anchor_from_numpy(fields, device) -> DeltaAnchor:
    """The reference's `DeltaAnchor` as the port's operand set.

    `fields` holds the 22 arrays as numpy arrays (a mapping by field
    name, or a sequence in field order), one lane (`A` 2-D, rows
    `(1, k)`) or batched (`A` 3-D, rows `(B, 1, k)`).  The 128-padding
    is kept: padded coordinates are inert (pads carry t0 = 0 and
    s0 = 2 sqrt(lam), mask 0).  The scalar row keeps its first 20
    slots."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    if not isinstance(fields, dict):
        fields = dict(zip(DeltaAnchor._fields, fields))
    A = np.asarray(fields["A"])
    B = 1 if A.ndim == 2 else A.shape[0]
    out = {}
    for name in DeltaAnchor._fields:
        x = np.array(fields[name], dtype=np.float32)
        if name == "A" or name == "Ninv":
            x = x.reshape((B,) + x.shape[-2:])
        else:
            x = x.reshape(B, -1)
            if name == "scal":
                x = x[:, :N_SCAL]
        out[name] = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return DeltaAnchor(**out)


class DeltaResult(NamedTuple):
    u: torch.Tensor         # (B, l) f64 absolute iterate after the chunk
    v: torch.Tensor
    u_sum: torch.Tensor     # (B, l) f64 stage-average accumulators after
    v_sum: torch.Tensor
    t_done: torch.Tensor    # (B,) int32 iterations executed
    qres: torch.Tensor      # (B,) f64 inner-criterion value (delta frame)
    avg_crit: torch.Tensor  # (B,) bool: the averaged iterate is better


def run_delta_chunk(A64, solve64, h, g, g_th, rho_y, lam, alpha, thresh,
                    u, v, u_sum, v_sum, sj, qres, *, T, probe,
                    A32=None, Ninv32=None, active=None) -> DeltaResult:
    """One anchored-delta chunk for every lane: build the anchor (f64),
    run up to T f32 iterations stopping at `qres < thresh`, return the
    f64 state.

    `active` (`(B,)` bool) gives inactive lanes zero iterations.  On CPU
    tensors the chunk runs the plain version; on CUDA tensors it
    launches the kernel, in the form `delta_launch_plan` picks (where
    the reference's `pallas_fits` gate, `abip_tpu/ops/admm_delta.py:
    536-549`, runs its XLA chunk, the kernel spills).  A build failure or
    a refused launch raises."""
    B, m, n = A64.shape
    if A64.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no delta chunk for device {A64.device}")
    with annotate("lp_batch.anchor"):
        anc = delta_anchor(A64, solve64, h, g, g_th, rho_y, lam, alpha,
                           thresh, u, v, u_sum, v_sum, sj, qres, A32=A32,
                           Ninv32=Ninv32)
    with annotate("lp_batch.k1"):
        t_max = torch.full((B,), T, dtype=torch.int32, device=A64.device)
        if active is not None:
            t_max = torch.where(active, t_max, 0).to(torch.int32)
        chunk = delta_chunk_cuda if A64.is_cuda else _delta_compute
        dy, dx, dvx, dsy, dsx, dsvx, row = chunk(anc, t_max, probe)
    with annotate("lp_batch.absorb"):
        row = row.to(f64)
        dtau, dkap, dstau, dskap, q = (row[:, k] for k in range(5))
        t_done = row[:, 5].to(torch.int32)
        avg_crit = row[:, 6] > 0.5
        # absolute f64 state: exact anchor frame + deltas
        kf = t_done.to(f64)[:, None]
        u_new = torch.cat([u[:, :m] + dy.to(f64), u[:, m:m + n] + dx.to(f64),
                           (u[:, m + n] + dtau)[:, None]], dim=1)
        v_new = torch.cat([v[:, :m], v[:, m:m + n] + dvx.to(f64),
                           (v[:, m + n] + dkap)[:, None]], dim=1)
        u_sum_new = u_sum + kf * u + torch.cat(
            [dsy.to(f64), dsx.to(f64), dstau[:, None]], dim=1)
        v_sum_new = v_sum + kf * v + torch.cat(
            [torch.zeros_like(u[:, :m]), dsvx.to(f64), dskap[:, None]], dim=1)
    return DeltaResult(u=u_new, v=v_new, u_sum=u_sum_new, v_sum=v_sum_new,
                       t_done=t_done, qres=q, avg_crit=avg_crit)

