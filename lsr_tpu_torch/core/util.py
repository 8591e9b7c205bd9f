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


def cdiv(a: int, b: int) -> int:
    """Ceiling division of host integers."""
    return -(-a // b)
