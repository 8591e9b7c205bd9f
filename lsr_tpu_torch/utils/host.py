"""Device -> host transfer helpers (port of lsr_tpu/utils/host.py: fetch,
fetch_image).

lsr_tpu widens u8 images to int32 on the device before each transfer, a
workaround for a slow u8 path of the remote TPU link it was written on.
PyTorch copies u8 tensors from a CUDA card at full rate, so the tensor is
copied as it is: the bytes are the same either way.
"""

from __future__ import annotations

import numpy as np
import torch


def fetch(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array, same dtype and
    bytes."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fetch_image(x) -> np.ndarray:
    """fetch, named for image edges."""
    return fetch(x)
