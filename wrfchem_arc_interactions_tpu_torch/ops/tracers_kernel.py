"""Fused multi-tracer RK-stage scalar update: CUDA kernel wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``wrfchem_arc_interactions_tpu/ops/pallas_adv_multi.py::
advect_tracers_fused``.  For a stack of nt tracers it computes one RK
stage's update, as the reference's scan body over stacked tracers does
(`dycore/solve.py`): 5th/3rd-order fluxes, optionally the positive-definite
limiter (`advection.pd_limit`), the flux divergence, ``+ mu_full * pt``
when a tendency stack is given, ``q_new = (phi_old + dts * tend) /
mu_new`` and optionally ``max(q_new, 0)``.  The tendency term is the
config-3 physics tendency (diffusion) that every scalar carries; the
limiter must see phi_old without it.

On a map-projected grid (``grid.has_msf``) the squared map factor m2 =
msft^2 scales the horizontal part of every divergence and of the
limiter's outflow sums, as the reference's ``flux_div(m_h=m2)``,
`advection.limit_low_order` and `advection.pd_limit` do.  The TPU kernel
never had it (the reference's projected grids take its plain operators);
like the ``mu_full * pt`` term it departs from the TPU kernel to compute
what the reference's plain path computes.  A specified lateral boundary
pads like an open one (edge replication) and takes the open code.

The kernel (``csrc/advect_tracers.cu``) is bound by memory on paper (~0.39 GB
per call at nt = 47 and 100x100x50, 0.12 ms at 3.35 TB/s); what costs time
on the card is the instructions around the arithmetic.  So a block owns a
tile of rows over the x row (or an x tile of it) of one tracer and marches
in z: planes of q, ru and rv come by asynchronous copy into rings in shared
memory, each thread owns a few fixed slots of the tile, and each face flux
is computed once.  A call is one grid (`GRIDS_PLAIN`, `GRIDS_LIMITED`), but
the limited stage on a block with a seam (`GRIDS_SEAM`, below).
With the limiter the grid's slots carry a 2-cell ring around the tile: in
one march it forms the low-order factor r_lo on the tile and the ring, the
low-order and antidiffusive fluxes and the antidiffusive factor r_hi on the
tile and its 1-ring, and the limited update of the tile, a level behind the
factors; no factor leaves the chip, which is what the TPU kernel does with
its halos of 4.  The 4th cell past a periodic edge, which the ring's
fluxes read and the stack's pad of 3 does not hold, comes from the wrapped
cell.  The source's header states the design in full.

Each grid runs on one of two launch plans (`plan` reports it): one tile
over the x row, or x tiles, each with the 3-cell x halo in its planes and
one more column of factors on each side (two with the limiter).  Without
the limiter one tile where one spans the row (`widest_row`: 255 cells at
two rows); with it the tile that holds the most cells.  Rows of any width
run, bitwise on either plan.

On a block of a process mesh (`parallel.mesh`) each side of the block
has an edge code: the lateral boundary's kind, or a SEAM where a
neighbouring block lies (a periodic axis split over several blocks has
seams on both sides).  Without the limiter the kernel reads only its
padded inputs, so seams change nothing.  With it, a face at a seam needs
the factors of the neighbour's edge cells, which the neighbour computes.
The plain version gets them by exchanging both factor rings (`hx.pad(r,
1)` in `advection.limit_low_order` and `pd_limit`).  The kernel takes the
same route (design (a): the reference plain path's), in two grids with an
exchange between them (`_seam_stage`): the wrapper passes phi_old, ww and
m2 with their exchanged one-cell ring, so that grid FACTOR forms r_lo on
the seam rings from the neighbours' true values, as the neighbour itself
does; grid FACTOR writes r_hi, the wrapper exchanges its one-cell ring,
and grid LIMITED reads that ring.  Both grids run on the grid of x tiles,
whose slots carry a halo column on each side.  The one-block grid's route
(r_hi formed on the ring) would need the neighbour's q 4 cells past the
seam, a wider halo exchange on every stage; this one costs one exchange
of an nt x nz x perimeter ring per limited stage (and the rings of
phi_old, ww and m2).

`advect_tracers` launches the kernel for CUDA tensors and runs
`advect_tracers_reference` for CPU tensors; it never falls back from one to
the other.  ``advect_tracers.launches`` counts the grids launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
from wrfchem_arc_interactions_tpu_torch.dycore import advection as adv
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.ops import build
from wrfchem_arc_interactions_tpu_torch.ops.stencil import PAD
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps

GRIDS_PLAIN = 1          # grids of one call without the limiter
GRIDS_LIMITED = 1        # ... with it: the limited stage in one grid
GRIDS_SEAM = 2           # ... with it on a block with a seam: FACTOR, then LIMITED
_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_SEAM_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                  + [ctypes.c_float] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_BC_CODE = {BCKind.PERIODIC: 0, BCKind.OPEN: 1, BCKind.SYMMETRIC: 2,
            BCKind.SPECIFIED: 1}
SEAM = 3                 # the edge code of a side where a neighbouring block lies
FACTOR, LIMITED = 1, 2   # the seam grids (advect_tracers_seam's `grid`); LIMITED is also
                         # the one-block limited grid's code in advect_tracers_plan


def edge_codes(hx: HaloOps) -> tuple:
    """The kernel's edge code of each side of the block (west, east,
    south, north)."""
    return tuple(SEAM if kind == "seam" else _BC_CODE[bc] for kind, bc in hx.edge_sides())


def map_factor_sq(grid: Grid) -> Optional[torch.Tensor]:
    """msft^2 (ny, nx) of a projected grid, None on a flat one."""
    return grid.msft * grid.msft if grid.has_msf else None


def advect_tracers_reference(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new,
                             grid: Grid, hx: HaloOps, dts: float,
                             pt: Optional[torch.Tensor] = None, pd: bool = False,
                             clip: bool = False) -> torch.Tensor:
    """Plain version: the stacked (nt, ...) chain of `dycore.advection` in
    the operation order of the reference's scan body."""
    fx, fy, fz = adv.scalar_fluxes(q_pad, ru_pad, rv_pad, ww, 5, 3)
    if pd:
        fx, fy, fz = adv.pd_limit(q_pad, phi_old, fx, fy, fz, ru_pad, rv_pad, ww,
                                  dts, grid, hx)
    tend = adv.flux_div(fx, fy, fz, grid, m_h=map_factor_sq(grid))
    if pt is not None:
        tend = tend + mu_full[None, None] * pt
    qn = (phi_old + dts * tend) / mu_new[None, None]
    if clip:
        qn = torch.clamp(qn, min=0.0)
    return qn


def _check(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new, rdnw, m2, pt, hx):
    tensors = {"q_pad": q_pad, "phi_old": phi_old, "ru_pad": ru_pad,
               "rv_pad": rv_pad, "ww": ww, "mu_full": mu_full, "mu_new": mu_new,
               "rdnw": rdnw}
    if m2 is not None:
        tensors["m2"] = m2
    if pt is not None:
        tensors["pt"] = pt
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q_pad.device:
            raise ValueError(f"{name} is on {t.device}, q_pad on {q_pad.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q_pad.dim() != 4:
        raise ValueError(f"q_pad must be (nt, nz, ny+6, nx+6), got {tuple(q_pad.shape)}")
    nt, nz, nyp, nxp = q_pad.shape
    ny, nx = nyp - 2 * PAD, nxp - 2 * PAD
    if min(nt, nz, ny, nx) < 1:
        raise ValueError(f"empty q_pad {tuple(q_pad.shape)}")
    want = {"phi_old": (nt, nz, ny, nx), "ru_pad": (nz, nyp, nxp),
            "rv_pad": (nz, nyp, nxp), "ww": (nz + 1, ny, nx), "mu_full": (ny, nx),
            "mu_new": (ny, nx), "rdnw": (nz,), "m2": (ny, nx), "pt": (nt, nz, ny, nx)}
    for name, t in tensors.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    for bc, n in ((hx.bc_x, nx), (hx.bc_y, ny)):
        if bc not in _BC_CODE:
            raise ValueError(f"unsupported lateral boundary {bc}")
        if bc == BCKind.SYMMETRIC and n < 2:
            raise ValueError("a symmetric boundary needs at least 2 cells")
    return nt, nz, ny, nx


def _seam_stage(fn, q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new, grid: Grid,
                hx: HaloOps, dts: float, pt, m2, clip: bool, out, edges, stream):
    """The limited update on a block with a seam: grid FACTOR on the
    ring-padded phi_old, ww and m2, the exchange of r_hi's ring, grid
    LIMITED.  Returns the first error code that is not 0."""
    nt, nz, ny, nx = out.shape
    phi_r, ww_r = hx.pad(phi_old, 1), hx.pad(ww, 1)
    m2_r = None if m2 is None else hx.pad(m2, 1)
    r_hi = torch.empty_like(out)

    def grid_(g, r_ring):
        return fn(g, q_pad.data_ptr(), phi_r.data_ptr(), None if pt is None else pt.data_ptr(),
                  ru_pad.data_ptr(), rv_pad.data_ptr(), ww_r.data_ptr(), mu_full.data_ptr(),
                  mu_new.data_ptr(), grid.rdnw.data_ptr(),
                  None if m2_r is None else m2_r.data_ptr(), r_hi.data_ptr(),
                  None if r_ring is None else r_ring.data_ptr(), out.data_ptr(),
                  nt, nz, ny, nx, float(grid.rdx), float(grid.rdy), float(dts), int(clip),
                  *edges, stream)

    err = grid_(FACTOR, None)
    if err != 0:
        return err
    r_ring = hx.pad(r_hi, 1)
    return grid_(LIMITED, r_ring)


def advect_tracers(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new,
                   grid: Grid, hx: HaloOps, dts: float,
                   pt: Optional[torch.Tensor] = None, pd: bool = False,
                   clip: bool = False) -> torch.Tensor:
    """New stage values (nt, nz, ny, nx) of a tracer stack.

    q_pad (nt, nz, ny+6, nx+6): the stage tracers padded by `hx`;
    phi_old (nt, nz, ny, nx): the coupled step-start tracers mu_0 q_0;
    ru_pad/rv_pad (nz, ny+6, nx+6), ww (nz+1, ny, nx): the mass fluxes;
    mu_full/mu_new (ny, nx): the stage and the new column mass; pt
    (nt, nz, ny, nx) or None: physics tendencies (uncoupled).  The model
    passes clip = pd.  On a projected grid the kernel takes m2 = msft^2."""
    m2 = map_factor_sq(grid)
    nt, nz, ny, nx = _check(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new,
                            grid.rdnw, m2, pt, hx)
    if q_pad.device.type == "cpu":
        return advect_tracers_reference(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full,
                                        mu_new, grid, hx, dts, pt, pd, clip)
    if q_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {q_pad.device}")
    lib = build.load("advect_tracers")
    out = torch.empty((nt, nz, ny, nx), dtype=torch.float32, device=q_pad.device)
    edges = edge_codes(hx)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q_pad.device):
        stream = torch.cuda.current_stream(q_pad.device).cuda_stream
        if pd and SEAM in edges:
            fn = lib.advect_tracers_seam
            fn.argtypes = _SEAM_ARGTYPES
            fn.restype = ctypes.c_int
            err = _seam_stage(fn, q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new, grid,
                              hx, dts, pt, m2, clip, out, edges, stream)
        else:
            fn = lib.advect_tracers
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            err = fn(q_pad.data_ptr(), phi_old.data_ptr(), ptr(pt), ru_pad.data_ptr(),
                     rv_pad.data_ptr(), ww.data_ptr(), mu_full.data_ptr(),
                     mu_new.data_ptr(), grid.rdnw.data_ptr(), ptr(m2), None,
                     out.data_ptr(),
                     nt, nz, ny, nx, float(grid.rdx), float(grid.rdy),
                     float(dts), int(pd), int(clip), *edges, stream)
    if err != 0:
        raise RuntimeError(f"advect_tracers launch failed: cudaError {err}")
    advect_tracers.launches += (GRIDS_SEAM if SEAM in edges else GRIDS_LIMITED) if pd \
        else GRIDS_PLAIN
    return out


advect_tracers.launches = 0


_PLAN_FIELDS = ("x_tiles", "slots_per_thread", "tile_rows", "tile_cells", "tiles_y", "tiles_x",
                "blocks", "smem_bytes", "resident", "registers", "local_bytes", "threads")


def plan(lib: ctypes.CDLL, pd: bool, nt: int, nz: int, ny: int, nx: int, msf: bool = False,
         seam: bool = False) -> list:
    """The grids the kernel library `lib` launches for one call at (nt, nz,
    ny, nx): one without the limiter or one with it; FACTOR's and LIMITED's
    of `advect_tracers_seam` if `seam`.  Each a dict: x tiles or one tile over
    the row, slots a thread, rows and cells of a tile, tiles over y and x,
    blocks, shared memory of a block, blocks an SM by the runtime's
    occupancy query, registers and local (spill) bytes a thread by
    cudaFuncGetAttributes, threads a block."""
    fn = lib.advect_tracers_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = []
    for g in (FACTOR, LIMITED) if seam else (LIMITED,) if pd else (0,):
        buf = (ctypes.c_int * len(_PLAN_FIELDS))()
        err = fn(g, int(seam), nt, nz, ny, nx, int(msf), buf)
        if err != 0:
            raise RuntimeError(f"advect_tracers_plan failed: cudaError {err}")
        p = dict(zip(_PLAN_FIELDS, buf))
        p["grid"] = ({FACTOR: "seam factor", LIMITED: "seam limited"}[g] if seam
                     else "limited" if pd else "plain")
        p["x_tiles"] = bool(p["x_tiles"])
        out.append(p)
    return out


def widest_row(pd: bool, ny: int = 2) -> int:
    """The widest x row (cells) up to which the call's grid takes one tile
    over the row at `ny` rows (CUDA library): without the limiter the widest
    one tile spans, past it x tiles; with it the widest up to which every
    row's tile of the most cells is one tile over the row."""
    fn = build.load("advect_tracers").advect_tracers_widest_row
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return int(fn(int(pd), int(ny)))
