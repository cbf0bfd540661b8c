"""Plain version of the port's fast-Mie Chebyshev evaluator (the port's
`ops/mie_kernel.py`, frozen): the kernel's wrapper is replaced by its plain
version, on every device, in pieces of `CUDA_PIECE` elements on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from port_bench.reference.wrf.chem import mie


@functools.lru_cache(maxsize=None)
def grid_matrix(device: torch.device) -> torch.Tensor:
    """`mie.build_grid_matrix()` as a row-major float32 tensor on `device`
    (the numpy matrix is column-major: it is built from transposes)."""
    return torch.from_numpy(np.ascontiguousarray(mie.build_grid_matrix())).to(device)


def cheb_eval_reference(nr_n, u, t):
    """Plain version: ``chem.optics._cheb_eval_bands`` (the band loop).
    Imported here, not at the top: `chem.optics` imports this module."""
    from port_bench.reference.wrf.chem.optics import _cheb_eval_bands
    return _cheb_eval_bands(grid_matrix(t.device), nr_n, u, t)


CUDA_PIECE = 1 << 24     # elements per plain pass on the card


def cheb_eval(nr_n, u, t):
    """(ln Q_ext, ln Q_sca, g_raw), each shaped like the (nband, ...)
    float32 inputs, by the plain version."""
    if t.device.type != "cuda" or t[0].numel() <= CUDA_PIECE:
        return cheb_eval_reference(nr_n, u, t)
    shape = t.shape
    flat = [a.reshape(shape[0], -1) for a in (nr_n, u, t)]
    outs = tuple(torch.empty_like(flat[2]) for _ in range(3))
    for a in range(0, flat[2].shape[1], CUDA_PIECE):
        b = a + CUDA_PIECE
        part = cheb_eval_reference(*(x[:, a:b] for x in flat))
        for o, p in zip(outs, part):
            o[:, a:b] = p
    return tuple(o.reshape(shape) for o in outs)
