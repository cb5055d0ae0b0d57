"""Fused barrier step: over-relaxation + log-barrier prox + dual update.

Port of `abip_tpu/ops/prox_pallas.py`.  The elementwise core of the
ADMM iteration (`project_barrier` + `update_dual_vars`,
`src/abip-lp/src/abip.c:567-748`):

    rel    = alpha * u_t + (1 - alpha) * u_prev
    t      = rel - v
    u_new  = prox(t, lam)          (the positive root of u^2 - t u - lam)
    v_new  = v + u_new - rel

`_ref_impl` is the plain PyTorch version; `csrc/barrier_step.cu` is the
CUDA kernel, f32 and f64.  `fused_barrier_step` takes the plain version
on CPU tensors and the kernel on CUDA tensors, or raises.  The prox is
`ops.admm_sprint.prox`, cancellation-free for t < 0 (the reference's
`_TINY = 1e-300` guard rounds to 0 in f32 and dominates t^2 in f64 once
|t| < ~1e-150; ROADMAP.md queue 3).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .admm_sprint import prox


def _ref_impl(u_t, u_prev, v, lam, alpha):
    """The plain version: (u_new, v_new) in the inputs' dtype."""
    rel = alpha * u_t + (1.0 - alpha) * u_prev
    u_new = prox(rel - v, lam)
    return u_new, v + u_new - rel


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from .build import load

    lib = load("barrier_step").lib
    for name in ("abip_barrier_step_f32", "abip_barrier_step_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.abip_barrier_step_residency.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.abip_barrier_step_residency.restype = ctypes.c_int
    lib.abip_empty_launch.argtypes = [ctypes.c_void_p]
    lib.abip_empty_launch.restype = ctypes.c_int
    lib.abip_cuda_error_string.argtypes = [ctypes.c_int]
    lib.abip_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err, what):
    if err:
        raise RuntimeError(f"{what} failed: "
                           + lib.abip_cuda_error_string(err).decode())


_ENTRY = {torch.float32: "abip_barrier_step_f32",
          torch.float64: "abip_barrier_step_f64"}
VEC_BYTES = 16        # one vector load or store of the kernel's body
THREADS = 256         # a block of `csrc/barrier_step.cu`


class StepPlan(NamedTuple):
    """How one launch of `csrc/barrier_step.cu` covers n elements: the
    scalar head [0, head), the body of `body` elements (16-byte vectors of
    `vec` elements, aligned in every operand), the scalar tail of `tail`
    elements, on `blocks` blocks of `THREADS` threads (0: no launch)."""
    vec: int
    head: int
    body: int
    tail: int
    blocks: int


def step_plan(n, itemsize, addresses, sms, resident):
    """The launch of n elements of `itemsize` bytes whose five operands
    (u_t, u_prev, v, u_new, v_new) start at byte `addresses`, on a card of
    `sms` SMs that holds `resident` blocks on each.  The body is 16-byte
    aligned in every operand; where the operands disagree modulo 16 bytes,
    or the body would hold no vector, every element is body with vec 1.
    The grid is one wave of resident blocks, fewer where the body has
    fewer vectors (or the head fewer elements) than that many threads."""
    vec = VEC_BYTES // itemsize
    residues = {a % VEC_BYTES for a in addresses}
    head = body = 0
    if len(residues) == 1:
        head = min(n, (-residues.pop() % VEC_BYTES) // itemsize)
        body = (n - head) // vec * vec
    if body == 0:
        vec, head, body = 1, 0, n
    work = max(body // vec, head, n - head - body)
    blocks = min(-(-work // THREADS), sms * resident)
    return StepPlan(vec, head, body, n - head - body, blocks)


@functools.lru_cache(maxsize=None)
def _residency(device_index, f64, vec):
    """(SMs, resident blocks) of the kernel of this type and width on the
    card `device_index`, from the occupancy API."""
    lib = _kernel_lib()
    resident, sms = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        _check(lib, lib.abip_barrier_step_residency(
            int(f64), vec, ctypes.byref(resident), ctypes.byref(sms)),
            "barrier_step occupancy query")
    return sms.value, resident.value


def _output_like(x):
    """An empty tensor of x's length, type and device whose address agrees
    with x's modulo 16 bytes (a view into a buffer a vector longer), so a
    view at an odd offset keeps the vector body."""
    k = VEC_BYTES // x.element_size()
    buf = torch.empty(x.numel() + k - 1, dtype=x.dtype, device=x.device)
    skip = (x.data_ptr() - buf.data_ptr()) % VEC_BYTES // x.element_size()
    return buf[skip:skip + x.numel()]


def barrier_step_cuda(u_t, u_prev, v, lam, alpha):
    """The step on the card: one launch of `csrc/barrier_step.cu` on
    three same-length contiguous 1-D f32 or f64 CUDA tensors (views at
    any offset), by `step_plan`.  Raises on an operand the kernel does
    not take and on a refused launch."""
    dev = u_t.device
    if dev.type != "cuda":
        raise ValueError(f"barrier_step_cuda needs CUDA tensors; got {dev}")
    if u_t.dtype not in _ENTRY:
        raise ValueError(f"barrier_step_cuda takes f32 or f64; got {u_t.dtype}")
    for name, x in (("u_t", u_t), ("u_prev", u_prev), ("v", v)):
        if (x.device != dev or x.dtype != u_t.dtype or x.dim() != 1
                or x.shape != u_t.shape or not x.is_contiguous()):
            raise ValueError(
                f"operand {name}: need contiguous {u_t.dtype} "
                f"{tuple(u_t.shape)} on {dev}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    u_new, v_new = _output_like(u_t), _output_like(u_t)
    n = u_t.numel()
    if n == 0:
        return u_new, v_new
    ops = (u_t, u_prev, v, u_new, v_new)
    size = u_t.element_size()
    plan = step_plan(n, size, [x.data_ptr() for x in ops],
                     *_residency(dev.index, size == 8,
                                 VEC_BYTES // size))
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _ENTRY[u_t.dtype])(
            *(x.data_ptr() for x in ops), n, plan.head,
            plan.body // plan.vec, plan.vec, plan.blocks, float(lam),
            float(alpha), ctypes.c_void_p(stream))
    _check(lib, err, "barrier_step kernel launch")
    barrier_step_cuda.launches += 1
    return u_new, v_new


def empty_launch_cuda(device):
    """One launch of an empty kernel on `device`'s current stream: the
    floor under a short kernel's time taken the same way (not counted)."""
    lib = _kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, lib.abip_empty_launch(ctypes.c_void_p(stream)),
               "empty kernel launch")


barrier_step_cuda.launches = 0


def fused_barrier_step(u_t, u_prev, v, lam, alpha):
    """Returns (u_new, v_new) on the barrier coordinates: 1-D tensors of
    one length (the tail u[m:]); lam, alpha floats.  CPU tensors take
    the plain version, CUDA tensors the kernel (f32 or f64)."""
    if u_t.is_cuda:
        return barrier_step_cuda(u_t.contiguous(), u_prev.contiguous(),
                                 v.contiguous(), lam, alpha)
    if u_t.device.type != "cpu":
        raise ValueError(f"no barrier step for device {u_t.device}")
    return _ref_impl(u_t, u_prev, v, lam, alpha)
