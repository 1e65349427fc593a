"""The port's device rule: its entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU (``device="cpu"``, which runs each
kernel's plain version). Where a call names a CUDA device and this process
sees none, :func:`require_device` raises :class:`NoCUDADevice` before any
work: an entry point never carries on on the CPU in the card's place."""

from __future__ import annotations

import torch


class NoCUDADevice(RuntimeError):
    """A call names a CUDA device where no CUDA device is present."""


def _names_cuda(device) -> bool:
    if isinstance(device, (list, tuple)):
        return any(_names_cuda(d) for d in device)
    return torch.device(device).type == "cuda"


def require_device(device, what: str):
    """``device`` as given (one device or a pool of them), after checking
    that a CUDA device is present where it names one; ``what`` names the
    caller in the error."""
    if _names_cuda(device) and not torch.cuda.is_available():
        raise NoCUDADevice(
            f"{what} needs a CUDA device, but no CUDA device is present; pass "
            "device='cpu' (--device cpu on the command line) to run the plain version"
        )
    return device
