"""Fast-Mie Chebyshev evaluator: CUDA kernel wrapper.

Replaces the TPU kernel ``wrfchem_arc_interactions_tpu/ops/pallas_mie.py::
cheb_eval_pallas``.  Both compute ``chem/optics.py::_cheb_eval_bands``, the
plain PyTorch version: from the normalised inputs (nr_n, u, t) of every
(band, cell) element, the bilinear hat weights over the (8, 10)
refractive-index grid, their contraction with the (90, 80) grid matrix and
three 30-term Clenshaw recurrences, giving (ln Q_ext, ln Q_sca, g_raw).
The kernel (``csrc/mie_cheb_eval.cu``) reads G as a packed corner table
(`packed_table`): for each floor cell of the grid and each of the 90 rows,
the four live entries of G as one float4, each cell padded to the count of
float4s the kernel's library gives (`launch_shape`).  Its header states
what bounds it and the design.

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


@functools.lru_cache(maxsize=None)
def grid_matrix(device: torch.device) -> torch.Tensor:
    """`mie.build_grid_matrix()` as a row-major float32 tensor on `device`
    (the numpy matrix is column-major: it is built from transposes)."""
    return torch.from_numpy(np.ascontiguousarray(mie.build_grid_matrix())).to(device)


@functools.lru_cache(maxsize=None)
def packed_table(device: torch.device, cell_stride: int) -> torch.Tensor:
    """The kernel's packed corner table, float32 (63, cell_stride, 4) on
    `device`: entry [9 ja + jb, r] holds G[r, c], G[r, c + 1], G[r, c + 10],
    G[r, c + 11] with c = 10 ja + jb, the columns of the hat weights w00,
    w01, w10, w11 of floor cell (ja, jb), ja < 7, jb < 9; rows 90 and up
    are zero.  `cell_stride` is the library's (`launch_shape`)."""
    G = mie.build_grid_matrix()
    if cell_stride < G.shape[0]:
        raise ValueError(f"cell_stride {cell_stride} < {G.shape[0]} rows of G")
    n_nr, n_ni = len(mie.NR_GRID), len(mie.NI_GRID)
    ja, jb = np.meshgrid(np.arange(n_nr - 1), np.arange(n_ni - 1), indexing="ij")
    cols = (n_ni * ja + jb).reshape(-1, 1) + np.array([0, 1, n_ni, n_ni + 1])
    table = np.zeros((cols.shape[0], cell_stride, 4), np.float32)
    table[:, :G.shape[0]] = np.transpose(G[:, cols], (1, 0, 2))
    return torch.from_numpy(table).to(device)


@functools.lru_cache(maxsize=None)
def launch_shape(lib: ctypes.CDLL) -> dict:
    """The launch constants of the kernel library `lib`: threads per block,
    resident blocks per SM, elements of a tile, float4s per cell of the
    packed table, and a block's dynamic shared memory in bytes."""
    fn = lib.mie_cheb_eval_shape
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 5)()
    fn(out)
    return dict(zip(("threads", "blocks_per_sm", "tile", "cell_stride", "smem_bytes"), out))


def grid_blocks(lib: ctypes.CDLL, n: int, sms: int) -> int:
    """Blocks of the persistent grid for `n` elements on `sms` SMs: one per
    tile, at most as many as the card holds at once."""
    shape = launch_shape(lib)
    return min(-(-n // shape["tile"]), shape["blocks_per_sm"] * sms)


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
    lib = build.load("mie_cheb_eval")
    fn = lib.mie_cheb_eval
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    n = t.numel()
    outs = tuple(torch.empty_like(t) for _ in range(3))
    if n == 0:
        return outs
    table = packed_table(t.device, launch_shape(lib)["cell_stride"])
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    blocks = grid_blocks(lib, n, sms)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(table.data_ptr(), nr_n.data_ptr(), u.data_ptr(), t.data_ptr(),
                 *(o.data_ptr() for o in outs), n, blocks, stream)
    if err != 0:
        raise RuntimeError(f"mie_cheb_eval launch failed: cudaError {err}")
    cheb_eval.launches += 1
    return outs


cheb_eval.launches = 0
