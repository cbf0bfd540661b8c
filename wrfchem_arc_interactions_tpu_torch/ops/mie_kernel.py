"""Fast-Mie Chebyshev evaluator: CUDA kernel wrapper.

Replaces the TPU kernel ``wrfchem_arc_interactions_tpu/ops/pallas_mie.py::
cheb_eval_pallas``.  Both compute ``chem/optics.py::_cheb_eval_bands``, the
plain PyTorch version: from the normalised inputs (nr_n, u, t) of every
(band, cell) element, the bilinear hat weights over the (8, 10)
refractive-index grid, their contraction with the (90, 80) grid matrix and
three 30-term Clenshaw recurrences, giving (ln Q_ext, ln Q_sca, g_raw).
The kernel (``csrc/mie_cheb_eval.cu``) is bound by its float operations
(~1,000 per element); its header states the design.

`cheb_eval` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other.
``cheb_eval.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.chem import mie
from wrfchem_arc_interactions_tpu_torch.ops import build

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_void_p])
THREADS = 256
BLOCKS_PER_SM = 7      # 7 x 28.8 KB of shared memory per SM


@functools.lru_cache(maxsize=None)
def grid_matrix(device: torch.device) -> torch.Tensor:
    """`mie.build_grid_matrix()` as a row-major float32 tensor on `device`
    (the numpy matrix is column-major: it is built from transposes)."""
    return torch.from_numpy(np.ascontiguousarray(mie.build_grid_matrix())).to(device)


def cheb_eval_reference(nr_n, u, t):
    """Plain version: ``chem.optics._cheb_eval_bands`` (the band loop).
    Imported here, not at the top: `chem.optics` imports this module."""
    from wrfchem_arc_interactions_tpu_torch.chem.optics import _cheb_eval_bands
    return _cheb_eval_bands(grid_matrix(t.device), nr_n, u, t)


def _check(nr_n, u, t):
    for name, a in (("nr_n", nr_n), ("u", u), ("t", t)):
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != t.device:
            raise ValueError(f"{name} is on {a.device}, t on {t.device}")
        if a.shape != t.shape:
            raise ValueError(f"{name} {tuple(a.shape)} != t {tuple(t.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t.dim() < 1:
        raise ValueError("inputs need a leading band axis")


def cheb_eval(nr_n, u, t):
    """(ln Q_ext, ln Q_sca, g_raw), each shaped like the (nband, ...)
    float32 inputs nr_n, u (in [0, 1]) and t (in [-1, 1])."""
    _check(nr_n, u, t)
    if t.device.type == "cpu":
        return cheb_eval_reference(nr_n, u, t)
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    fn = build.load("mie_cheb_eval").mie_cheb_eval
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    n = t.numel()
    outs = tuple(torch.empty_like(t) for _ in range(3))
    if n == 0:
        return outs
    G = grid_matrix(t.device)
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    blocks = min(-(-n // THREADS), BLOCKS_PER_SM * sms)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(G.data_ptr(), nr_n.data_ptr(), u.data_ptr(), t.data_ptr(),
                 *(o.data_ptr() for o in outs), n, blocks, stream)
    if err != 0:
        raise RuntimeError(f"mie_cheb_eval launch failed: cudaError {err}")
    cheb_eval.launches += 1
    return outs


cheb_eval.launches = 0
