"""Pure-f32 LP ADMM sprints: T whole iterations in one launch.

Port of `abip_tpu/ops/admm_pallas.py`.  Two kernels share one iteration
(projection with the rank-1 tau correction, explicit N^-1 apply,
back-substitution, barrier prox, dual update; `abip.c:539-584`,
`:717-748`):

* the stopping sprint (`fused_admm_sprint_stop`): up to T iterations,
  the HSD-operator residual `qres` (`abip.c:1951-1996`) probed every
  `probe` iterations, each lane stopping at `qres < thresh`; the x prox
  is masked.  Phase 1 of the LP `sprint2` engine and the chunk of the
  `sprint` engine under cadence "chunk".
* the plain sprint (`fused_admm_sprint`): exactly T iterations, no
  stop.  The `sprint` engine under cadence "cond".

`_sprint_compute` is the plain PyTorch version of both (CPU tensors,
and the reference the kernel is held to); `csrc/admm_sprint.cu` is the
CUDA kernel, one thread-block cluster per lane on K1's plan
(`sprint_launch_plan`; spilled to a global workspace where no shared
memory holds a CTA, so that it takes every shape).  The entries take the
plain version on CPU tensors and the kernel on CUDA tensors.

The barrier prox takes the cancellation-free form for t < 0,
2 lam / (sqrt(t^2 + 4 lam) - t).  The reference's form divides by
-t (1 + sqrt(1 + 4 lam / (t^2 + 1e-30))) + 1e-30, whose guard dominates
t^2 once |t| < ~1e-15 and returns up to 1e5 times the prox there
(ROADMAP.md queue 3).

Layout: lane axis first, no padding.  Rows are `(B, m)`/`(B, n)` f32,
`A` is `(B, m, n)`, `Ninv` = (rho_y I + A A')^-1 is `(B, m, m)`, and the
per-lane scalars are one `(B, 8)` f32 tensor (slots `S_*`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..device import smem_optin
from .admm_delta import (SMEM_OPTIN, THREADS, DeltaPlan, _cuda_error, _mv,
                         _per_lane, _rmv, check_plan, cluster_plan,
                         cluster_smem_bytes, cluster_workspace)

f32 = torch.float32
f64 = torch.float64

# scal slots
S_RHOY, S_IGTH, S_LAM, S_ALPHA, S_TAU0, S_KAPPA0, S_THRESH = range(7)
N_SCAL = 8
# output row: [tau, kappa, qres, t_done]
ROW_WIDTH = 4


class SprintOperands(NamedTuple):
    """f32 operands of one sprint launch, lane axis first."""

    scal: torch.Tensor    # (B, 8) per-lane scalars, slots S_*
    A: torch.Tensor       # (B, m, n)
    Ninv: torch.Tensor    # (B, m, m)
    hy: torch.Tensor      # (B, m) HSD rank-1 data h = (-b; c)
    hx: torch.Tensor      # (B, n)
    gy: torch.Tensor      # (B, m) g = K^-1 h
    gx: torch.Tensor      # (B, n)
    maskx: torch.Tensor   # (B, n) x prox mask (ones where nothing is padded)
    y: torch.Tensor       # (B, m) entry iterate
    x: torch.Tensor       # (B, n)
    vy: torch.Tensor      # (B, m) the y dual: constant through the sprint
    vx: torch.Tensor      # (B, n)


_M_FIELDS = ("hy", "gy", "y", "vy")


def prox(t, lam):
    """Log-barrier prox, the positive root of u^2 - t u - lam = 0
    (`abip.c:717-748`), in the dtype of `t`; the t < 0 branch without
    cancellation."""
    s = torch.sqrt(t * t + 4.0 * lam)
    return torch.where(t >= 0, 0.5 * (t + s), 2.0 * lam / (s - t))


def _sprint_compute(op: SprintOperands, t_max, probe):
    """The plain PyTorch version of both sprint kernels.

    probe > 0 (the stopping sprint): lane b runs trips of `probe`
    iterations while `t < t_max[b]` and `qres >= thresh`, `qres` taken
    after each trip.  probe = 0 (the plain sprint): lane b runs exactly
    `t_max[b]` iterations and `qres` stays inf.  Stopped lanes are
    frozen by mask.  Returns (y, x, vx, row) with row `(B, 4)` =
    [tau, kappa, qres, t_done], in the operands' dtype (f32 as the
    kernel, or f64 to measure the f32 versions' own error)."""
    A, Ninv, sc = op.A, op.Ninv, op.scal
    if A.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the sprint needs IEEE f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")

    def col(k):
        return sc[:, k:k + 1]

    rho_y, inv_gth1, lam = col(S_RHOY), col(S_IGTH), col(S_LAM)
    alpha, thresh = col(S_ALPHA), col(S_THRESH)
    hy, hx, gy, gx, maskx, vy = op.hy, op.hx, op.gy, op.gx, op.maskx, op.vy

    def bsum(x):
        return x.sum(-1, keepdim=True)

    def iter_body(y, x, vx, tau, kappa):
        qy = rho_y * (y + vy) - (tau + kappa) * hy
        qx = (x + vx) - (tau + kappa) * hx
        coef = (bsum(qy * gy) + bsum(qx * gx)) * inv_gth1
        qy = qy - coef * hy
        wx = -(qx - coef * hx)
        z_y = _mv(Ninv, qy + _mv(A, wx))
        z_x = _rmv(A, z_y) - wx
        tau_t = (tau + kappa) + bsum(z_y * hy) + bsum(z_x * hx)
        rel_x = alpha * z_x + (1.0 - alpha) * x
        rel_tau = alpha * tau_t + (1.0 - alpha) * tau
        x_new = prox(rel_x - vx, lam) * maskx
        tau_new = prox(rel_tau - kappa, lam)
        return (z_y - vy, x_new, (vx + x_new) - rel_x, tau_new,
                (kappa + tau_new) - rel_tau)

    vy2 = bsum(vy * vy)

    def qres(y, x, vx, tau, kappa):
        q1 = _mv(A, x) + tau * hy
        q2 = (_rmv(A, y) + vx - tau * hx) * maskx
        q3 = -bsum(y * hy) - bsum(x * hx) - kappa
        qsq = bsum(q1 * q1) + bsum(q2 * q2) + q3 * q3
        un = bsum(y * y) + bsum(x * x) + tau * tau
        vn = vy2 + bsum(vx * vx) + kappa * kappa
        return torch.sqrt(qsq) / (1.0 + torch.sqrt(un + vn))

    B, dev = A.shape[0], A.device
    t_max = t_max.to(device=dev, dtype=torch.int32).reshape(B, 1)
    state = (op.y, op.x, op.vx, col(S_TAU0), col(S_KAPPA0))
    t = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    q = torch.full_like(col(S_TAU0), float("inf"))
    step = probe if probe > 0 else 1
    while True:
        run = (t < t_max) & (q >= thresh) if probe > 0 else t < t_max
        if not bool(run.any()):
            break
        new = state
        for _ in range(step):
            new = iter_body(*new)
        state = tuple(torch.where(run, a, s) for a, s in zip(new, state))
        if probe > 0:
            q = torch.where(run, qres(*new), q)
        t = torch.where(run, t + step, t)
    y, x, vx, tau, kappa = state
    return y, x, vx, torch.cat([tau, kappa, q, t.to(q.dtype)], dim=1)


# The kernels' launch: K1's cluster plan (`ops/admm_delta.cluster_plan`)
# with this kernel's slices: a resident CTA holds hx, gx, the mask, x and
# vx (5 x-side slices) and y, vy, the rhs and z_y (4 m-vectors).
SPRINT_CLUSTER = 6
_X_SLICES = 5
_M_VECS = 4


def sprint_smem_bytes(m, n, cluster, resident):
    """Dynamic shared memory of one CTA of K6 and K7
    (`csrc/admm_sprint.cu:smem_floats`)."""
    return cluster_smem_bytes(m, n, cluster, resident, _X_SLICES, _M_VECS)


def sprint_launch_plan(m, n, smem_limit=SMEM_OPTIN):
    """The launch of a sprint of shape (m, n): clusters of SPRINT_CLUSTER
    CTAs, resident if that fits `smem_limit`, else streaming A, Ninv
    and the x-side operands through L2, else spilled (at m=15,000 the
    streaming form's exchange buffers alone, 4 m floats, exceed an
    H100's shared memory).  Where the reference runs its XLA sprint
    because its kernel does not fit VMEM, the port's kernels spill."""
    return cluster_plan(m, n, smem_limit, _X_SLICES, _M_VECS, SPRINT_CLUSTER)


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from .build import load

    lib = load("admm_sprint").lib
    lib.abip_sprint.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.abip_sprint.restype = ctypes.c_int
    lib.abip_sprint_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.abip_sprint_smem_bytes.restype = ctypes.c_longlong
    lib.abip_sprint_work_floats.argtypes = [ctypes.c_int] * 4
    lib.abip_sprint_work_floats.restype = ctypes.c_longlong
    lib.abip_sprint_max_active_clusters.argtypes = [
        ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.abip_sprint_max_active_clusters.restype = ctypes.c_int
    for fn in (lib.abip_sprint_row_width, lib.abip_sprint_threads):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.abip_cuda_error_string.argtypes = [ctypes.c_int]
    lib.abip_cuda_error_string.restype = ctypes.c_char_p
    if (lib.abip_sprint_row_width() != ROW_WIDTH
            or lib.abip_sprint_threads() != THREADS
            or lib.abip_sprint_work_floats(4, 1, 1, 0) != 4 * _M_VECS):
        raise RuntimeError("csrc/admm_sprint.cu and its wrapper disagree on "
                           "the output row, the threads or the workspace")
    return lib


@functools.lru_cache(maxsize=None)
def sprint_max_active_clusters(m, n, plan: DeltaPlan, device_index=0):
    """How many of the plan's clusters the card holds at once
    (`cudaOccupancyMaxActiveClusters`).  A lane is one cluster; more
    lanes than this queue."""
    lib = _kernel_lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.abip_sprint_max_active_clusters(
            m, n, plan.cluster, int(plan.resident), int(plan.spill),
            ctypes.byref(out))
    if err:
        raise _cuda_error(lib, "admm_sprint occupancy query failed", err)
    return out.value


def _launch(op: SprintOperands, t_max, probe, plan):
    B, m, n = op.A.shape
    dev = op.A.device
    if dev.type != "cuda":
        raise ValueError(f"the sprint kernels need CUDA tensors; got {dev}")
    if B < 1 or m < 1 or n < 1 or probe < 0:
        raise ValueError(f"empty launch: B={B} m={m} n={n} probe={probe}")
    want = {"scal": (B, N_SCAL), "A": (B, m, n), "Ninv": (B, m, m)}
    for name, x in op._asdict().items():
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
        plan = sprint_launch_plan(m, n, limit)
    check_plan(plan, limit)
    lib = _kernel_lib()
    if lib.abip_sprint_smem_bytes(m, n, plan.cluster, int(plan.resident),
                                  int(plan.spill)) != plan.smem_bytes:
        raise RuntimeError("csrc/admm_sprint.cu and its wrapper disagree on "
                           "the shared memory of a CTA")
    if sprint_max_active_clusters(m, n, plan, dev.index or 0) < 1:
        raise RuntimeError(
            f"the card cannot hold one cluster of {plan.cluster} CTAs with "
            f"{plan.smem_bytes} B of shared memory each (m={m} n={n})")
    outs = [torch.empty((B, k), dtype=f32, device=dev)
            for k in (m, n, n, ROW_WIDTH)]
    ins = (ctypes.c_void_p * (len(op) + 1))(
        *[x.data_ptr() for x in op], t_max.data_ptr())
    outp = (ctypes.c_void_p * len(outs))(*[x.data_ptr() for x in outs])
    # the streaming form keeps each CTA's m-side vectors in global
    # memory, the spilled form its whole layout
    work = cluster_workspace(lib.abip_sprint_work_floats, B, plan, dev, m, n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abip_sprint(
            ins, outp, None if work is None else work.data_ptr(), B, m, n,
            probe, plan.cluster, int(plan.resident), int(plan.spill),
            ctypes.c_void_p(stream))
    if err:
        raise _cuda_error(lib, "admm_sprint kernel launch failed", err)
    return tuple(outs)


def sprint_stop_cuda(op: SprintOperands, t_max, probe, plan=None):
    """The stopping sprint (K6) on the card: one launch of
    `csrc/admm_sprint.cu`, one thread-block cluster per lane, by
    `sprint_launch_plan`.  Same contract as `_sprint_compute` with
    probe > 0.  `plan` replaces the launch plan, to time other cluster
    sizes and check other forms; the solvers never pass it.  Raises on
    an operand the kernel does not take, on a plan the card cannot hold
    and on a refused launch; never falls back."""
    if probe < 1:
        raise ValueError(f"the stopping sprint needs probe >= 1; got {probe}")
    out = _launch(op, t_max, probe, plan)
    sprint_stop_cuda.launches += 1
    return out


def sprint_cuda(op: SprintOperands, t_max, plan=None):
    """The plain sprint (K7) on the card: exactly t_max[b] iterations of
    lane b, one launch, the same clusters as K6.  Same contract as
    `_sprint_compute` with probe = 0."""
    out = _launch(op, t_max, 0, plan)
    sprint_cuda.launches += 1
    return out


sprint_stop_cuda.launches = 0
sprint_cuda.launches = 0


def sprint_operands(A32, Ninv32, h32, g32, rho_y, inv_gth1, lam, alpha,
                    thresh, u32, v32, maskx=None) -> SprintOperands:
    """Pack one launch's operands.  h32, g32 `(B, m + n)` (a trailing
    entry is ignored); u32, v32 `(B, m + n + 1)`; the scalars floats or
    `(B,)` tensors."""
    B, m, n = A32.shape
    scal = torch.stack([_per_lane(s, B, A32) for s in (
        rho_y, inv_gth1, lam, alpha, u32[:, m + n], v32[:, m + n], thresh,
        0.0)], dim=1).to(f32)

    def row(x):
        return x.to(f32).contiguous()

    if maskx is None:
        maskx = torch.ones((B, n), dtype=f32, device=A32.device)
    return SprintOperands(
        scal=scal, A=A32.to(f32).contiguous(), Ninv=Ninv32.to(f32).contiguous(),
        hy=row(h32[:, :m]), hx=row(h32[:, m:m + n]), gy=row(g32[:, :m]),
        gx=row(g32[:, m:m + n]), maskx=row(maskx), y=row(u32[:, :m]),
        x=row(u32[:, m:m + n]), vy=row(v32[:, :m]), vx=row(v32[:, m:m + n]))


def _lanes(A32, *vecs):
    """One lane (2-D A, 1-D vectors) as a stack of one; stacks pass."""
    if A32.dim() == 3:
        return False, (A32,) + vecs
    return True, (A32[None],) + tuple(v[None] for v in vecs)


def _run(op, t_max, probe, active):
    """Both sprints' dispatch: the plain version on CPU tensors, the
    kernel on CUDA tensors (where the reference's `pallas_fits` gate,
    `abip_tpu/ops/admm_pallas.py:432`, `:501`, runs its XLA sprint, the
    kernel spills)."""
    B = op.A.shape[0]
    t_max = torch.full((B,), t_max, dtype=torch.int32, device=op.A.device)
    if active is not None:
        t_max = torch.where(active, t_max, 0).to(torch.int32)
    if op.A.is_cuda:
        return (sprint_stop_cuda(op, t_max, probe) if probe > 0
                else sprint_cuda(op, t_max))
    if op.A.device.type != "cpu":
        raise ValueError(f"no sprint for device {op.A.device}")
    return _sprint_compute(op, t_max, probe)


def _iterates(op, y, x, vx, row):
    u = torch.cat([y, x, row[:, 0:1]], dim=1)
    v = torch.cat([op.vy, vx, row[:, 1:2]], dim=1)
    return u, v


def fused_admm_sprint_stop(A32, Ninv32, h32, g32, rho_y, g_th, lam, alpha,
                           thresh, u32, v32, *, T=768, probe=8, active=None):
    """Run up to T f32 ADMM iterations per lane in one launch, stopping
    within probe-1 iterations of the inner criterion `qres < thresh`.

    One lane (A32 `(m, n)`, vectors `(l,)`) or a stack (`(B, ...)`).
    Ninv32 = (rho_y I + A A')^-1; h32, g32 the HSD rank-1 data
    (`abip.c:1917-1924`); lam = mu/beta.  The rank-1 weight
    1 / (g_th + 1) is formed in f64 and rounded to f32, as the
    reference forms it.  `active` (`(B,)` bool) gives inactive lanes
    zero iterations.  Returns (u, v, t_done, qres), f32 iterates and
    per-lane int32 / f32 (0-d for one lane)."""
    one, (A32, Ninv32, h32, g32, u32, v32) = _lanes(
        A32, Ninv32, h32, g32, u32, v32)
    inv_gth1 = 1.0 / (torch.as_tensor(g_th, dtype=f64) + 1.0)
    op = sprint_operands(A32, Ninv32, h32, g32, rho_y, inv_gth1, lam, alpha,
                         thresh, u32, v32)
    y, x, vx, row = _run(op, T, probe, active)
    u, v = _iterates(op, y, x, vx, row)
    out = (u, v, row[:, 3].to(torch.int32), row[:, 2])
    return tuple(o[0] for o in out) if one else out


def fused_admm_sprint(A32, Ninv32, h32, g32, rho_y, g_th, lam, alpha, u32,
                      v32, *, T=32, active=None):
    """Run exactly T f32 ADMM iterations per lane in one launch; returns
    (u, v), f32.  The arguments are those of `fused_admm_sprint_stop`
    without the threshold; here the rank-1 weight 1 / (g_th + 1) is
    formed in f32, as the reference forms it for this kernel."""
    one, (A32, Ninv32, h32, g32, u32, v32) = _lanes(
        A32, Ninv32, h32, g32, u32, v32)
    inv_gth1 = 1.0 / (torch.as_tensor(g_th).to(f32) + 1.0)
    op = sprint_operands(A32, Ninv32, h32, g32, rho_y, inv_gth1, lam, alpha,
                         float("-inf"), u32, v32)
    y, x, vx, row = _run(op, T, 0, active)
    u, v = _iterates(op, y, x, vx, row)
    return (u[0], v[0]) if one else (u, v)
