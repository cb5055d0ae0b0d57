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
            ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.abip_cuda_error_string.argtypes = [ctypes.c_int]
    lib.abip_cuda_error_string.restype = ctypes.c_char_p
    return lib


_ENTRY = {torch.float32: "abip_barrier_step_f32",
          torch.float64: "abip_barrier_step_f64"}


def barrier_step_cuda(u_t, u_prev, v, lam, alpha):
    """The step on the card: one launch of `csrc/barrier_step.cu` on
    three same-length contiguous 1-D f32 or f64 CUDA tensors.  Raises on
    an operand the kernel does not take and on a refused launch."""
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
    u_new, v_new = torch.empty_like(u_t), torch.empty_like(u_t)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _ENTRY[u_t.dtype])(
            u_t.data_ptr(), u_prev.data_ptr(), v.data_ptr(),
            u_new.data_ptr(), v_new.data_ptr(), u_t.numel(), float(lam),
            float(alpha), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError("barrier_step kernel launch failed: "
                           + lib.abip_cuda_error_string(err).decode())
    barrier_step_cuda.launches += 1
    return u_new, v_new


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
