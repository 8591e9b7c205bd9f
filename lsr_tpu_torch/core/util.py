"""Small helpers shared by the port's modules."""

from __future__ import annotations

import numpy as np
import torch


def device_const(values, device, dtype=torch.float32):
    """A small constant tensor on `device`, made without a device sync.

    torch.tensor(data, device="cuda") copies and then synchronizes the
    stream; staging host data with non_blocking=True does not, so a frame
    that builds its constants this way keeps the card's queue full."""
    return torch.as_tensor(np.asarray(values), dtype=dtype).to(
        device, non_blocking=True)


def default_device() -> torch.device:
    """The device the port's entry points use when the caller names none:
    the CUDA card.  Raises when there is no card; the CPU (the kernels'
    plain versions) is only ever used when asked for with device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "lsr_tpu_torch runs on the CUDA card unless told otherwise, and "
            "torch.cuda.is_available() is False: pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; None means default_device()."""
    return default_device() if device is None else torch.device(device)


def cdiv(a: int, b: int) -> int:
    """Ceiling division of host integers."""
    return -(-a // b)
