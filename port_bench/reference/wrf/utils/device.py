"""Device selection for the port's entry points.

The port runs on the GPU.  The CPU is used only when the caller asks for it
(the CPU tests do): with no device given and no CUDA device present the
entry points raise rather than fall back.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

# elements of the largest temporary that one pass of a stage may make (2^28,
# a GiB of float32).  A stage that is independent along an axis (the chem
# call along its rows of columns, the subgrid mixing along its scalars) runs
# in passes over slices of that axis where the whole would make a larger
# one: every main path at 100x100 and 1000x100 columns takes one pass, and
# config 5's 500x500x60 block, which in one ran out of an H100's 80 GB,
# takes 2 chem blocks of rows and 6 diffusion passes (PERF.md).
PASS_ELEMENTS = 1 << 28


def pass_slices(n: int, per_item: int) -> List[Tuple[int, int]]:
    """The (a, b) slices of an axis of `n` items, each making `per_item`
    elements of the largest temporary, that passes of at most
    `PASS_ELEMENTS` take: as few as fit, of equal length but the last."""
    passes = max(1, -(-n * per_item // PASS_ELEMENTS))
    per = -(-n // passes)
    return [(a, min(n, a + per)) for a in range(0, n, per)]


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
