"""What the port carries so far, and which slice brings the rest.

The port goes slice by slice (ROADMAP.md, Queue 1).  It carries every
physics and dycore option of the reference on a single device over an
ideal flat grid: the dycore with every advection order (WENO5 included),
the positive-definite and monotonic limiters, Smagorinsky or 1.5-order TKE
diffusion with the 6th-order filter, SPPT and SKEBS; Kessler, WSM6 and
Morrison microphysics with aerosol activation; the YSU and MYNN boundary
layers over the slab surface or the Noah land surface; BMJ, KF and Grell
cumulus; RRTMG or the simple radiation; the whole chem driver for every
package; and the run infrastructure (history, restart, auxhist, tslist,
the NaN guard, the emission stream).  Options outside these (real data and
nesting, several GPUs) raise `NotImplementedError` naming the slice that brings
them, so that nothing runs silently with a piece missing.
"""

from __future__ import annotations

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind

SLICE_REAL = "a later slice (ROADMAP Queue 1 item 9, real data and nesting)"
SLICE_MESH = "a later slice (ROADMAP Queue 1 item 10, multi-GPU decomposition)"


def unported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with {where}")


def check_config(cfg: Config) -> None:
    """Raise `NotImplementedError` for any option the port does not carry."""
    dyn = cfg.dynamics
    if cfg.chem.aer_op_opt != 1:
        raise NotImplementedError(
            f"aer_op_opt={cfg.chem.aer_op_opt}: the reference reads this option nowhere "
            "and always mixes by volume (option 1); the port refuses other values "
            "rather than ignore them")
    if dyn.fft_filter_lat < 90.0:
        raise unported("the polar FFT filter", SLICE_REAL)
    if BCKind.SPECIFIED in (dyn.bc_x, dyn.bc_y):
        raise unported("specified lateral boundaries", SLICE_REAL)
    if cfg.fdda.grid_fdda:
        raise unported("analysis nudging (grid_fdda)", SLICE_REAL)
    if cfg.parallel.mesh_x > 1 or cfg.parallel.mesh_y > 1:
        raise unported("a device mesh", SLICE_MESH)


def check_grid(grid) -> None:
    if grid.has_terrain:
        raise unported("terrain", SLICE_REAL)
    if grid.curvature:
        raise unported("map projections", SLICE_REAL)
