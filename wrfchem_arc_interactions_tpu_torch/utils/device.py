"""Device selection for the port's entry points.

The port runs on the GPU.  The CPU is used only when the caller asks for it
(the CPU tests do): with no device given and no CUDA device present the
entry points raise rather than fall back.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raise if that is asked for and absent.

    Also switches TF32 off for float32 matmuls and convolutions, so that a
    float32 result here means float32 arithmetic (the slice has no matmul;
    later slices do).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return dev


def to_numpy64(t: torch.Tensor) -> np.ndarray:
    """Host float64 copy of a tensor (for the numpy-side case setup)."""
    return t.detach().cpu().numpy().astype(np.float64)


def sync(device: torch.device) -> None:
    """Block until all queued work on `device` has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
