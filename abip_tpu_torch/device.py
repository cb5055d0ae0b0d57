"""The device an entry point runs on.

Every entry point of the port runs on the CUDA card unless the caller
asks for another device: `device=None` means "cuda", and without a
visible card that is an error, never a silent fall back to the CPU.
A caller asks for the CPU with `device="cpu"`, as the tests do.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def float_dtype(dtype) -> torch.dtype:
    """`torch.float32` or `torch.float64` from a torch dtype, a numpy
    dtype or scalar type, a name ("float32"), or any dtype object numpy
    reads (JAX's `jnp.float32`, for one).  Other types raise
    `ValueError`."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64; got {dtype!r}")
    return getattr(torch, name)


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None.  Raises when the
    device asked for (or defaulted to) is CUDA and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "abip_tpu_torch runs on a CUDA card by default and none is "
            "visible; pass device='cpu' to run on the CPU")
    return dev


_SMEM_CAP = [None]


def smem_optin(device) -> int:
    """The shared memory one thread block may use on a CUDA `device`
    (`sharedMemPerBlockOptin`), or less under `limit_shared_memory`:
    what the kernels' launch plans weigh a CTA against."""
    card = torch.cuda.get_device_properties(
        torch.device(device)).shared_memory_per_block_optin
    return card if _SMEM_CAP[0] is None else min(card, _SMEM_CAP[0])


@contextlib.contextmanager
def limit_shared_memory(nbytes):
    """Within the block, the launch plans see at most `nbytes` of shared
    memory per block, so that the kernels take the forms they take for
    shapes the card's shared memory does not hold (streaming, spilled)
    at any shape: how the card tests and the smoke check those forms."""
    old = _SMEM_CAP[0]
    _SMEM_CAP[0] = int(nbytes)
    try:
        yield
    finally:
        _SMEM_CAP[0] = old


@contextlib.contextmanager
def ieee_f32():
    """Keep float32 matrix products out of TF32 for the duration; the
    caller's setting is restored on exit.  It uses the API the caller
    set TF32 with: PyTorch raises on a read of the legacy `allow_tf32`
    once the caller set the other way (`fp32_precision`), so that one
    is switched to "ieee" instead."""
    matmul = torch.backends.cuda.matmul
    precision = matmul.fp32_precision
    try:
        legacy = matmul.allow_tf32
    except RuntimeError:
        legacy = None
    if legacy is None:
        matmul.fp32_precision = "ieee"
    else:
        matmul.allow_tf32 = False
    try:
        yield
    finally:
        if legacy is not None:
            matmul.allow_tf32 = legacy
        matmul.fp32_precision = precision
