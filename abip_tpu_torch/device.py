"""The device an entry point runs on.

Every entry point of the port runs on the CUDA card unless the caller
asks for another device: `device=None` means "cuda", and without a
visible card that is an error, never a silent fall back to the CPU.
A caller asks for the CPU with `device="cpu"`, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None.  Raises when the
    device asked for (or defaulted to) is CUDA and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "abip_tpu_torch runs on a CUDA card by default and none is "
            "visible; pass device='cpu' to run on the CPU")
    return dev
