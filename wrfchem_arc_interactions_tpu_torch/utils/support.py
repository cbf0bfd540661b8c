"""What the port carries so far, and which slice brings the rest.

The port goes slice by slice (ROADMAP.md, Queue 1).  Slice 1 is the
"main" executable of BASELINE config 3 with radiation and chemistry off:
dycore + Smagorinsky diffusion + Kessler, single device, ideal flat grid.
Every option outside it raises `NotImplementedError` naming the slice that
brings it, so that nothing runs silently with a piece missing.
"""

from __future__ import annotations

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import (
    AdvLimiter,
    AdvOrder,
    BCKind,
    ChemOpt,
    CUScheme,
    KMOpt,
    MPScheme,
    PBLScheme,
    RAScheme,
    SFScheme,
    SFSurface,
)

SLICE_RAD = "slice 2 (config 3 radiation + aerosol optics + the Mie kernel)"
SLICE_CHEM = "slice 3 (config 4: Morrison, MOSAIC, CBM-Z with the ROS2 and " \
             "multi-tracer kernels)"
SLICE_PHYS = "a later slice (ROADMAP Queue 1 item 7, remaining physics)"
SLICE_REAL = "a later slice (ROADMAP Queue 1 item 9, real data and nesting)"
SLICE_MESH = "a later slice (ROADMAP Queue 1 item 10, multi-GPU decomposition)"


def _unported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with {where}")


def check_config(cfg: Config) -> None:
    """Raise `NotImplementedError` for any option this slice does not port."""
    ph, dyn, ch = cfg.physics, cfg.dynamics, cfg.chem
    if ph.ra_sw_physics != RAScheme.NONE or ph.ra_lw_physics != RAScheme.NONE:
        raise _unported("radiation (ra_sw/ra_lw_physics)", SLICE_RAD)
    if ch.chem_opt != ChemOpt.NONE:
        where = SLICE_RAD if ch.chem_opt == ChemOpt.MOSAIC_4BIN else SLICE_CHEM
        raise _unported(f"chemistry (chem_opt={ch.chem_opt.value})", where)
    if ph.mp_physics == MPScheme.MORRISON2 or ph.progn:
        raise _unported("Morrison microphysics", SLICE_CHEM)
    if ph.mp_physics == MPScheme.WSM6:
        raise _unported("WSM6 microphysics", SLICE_PHYS)
    if ph.bl_pbl_physics != PBLScheme.NONE or ph.sf_sfclay_physics != SFScheme.NONE:
        raise _unported("PBL / surface layer", SLICE_PHYS)
    if ph.sf_surface_physics == SFSurface.NOAH:
        raise _unported("the Noah land surface", SLICE_PHYS)
    if ph.cu_physics != CUScheme.NONE:
        raise _unported("cumulus", SLICE_PHYS)
    if ph.tke_heat_flux > 0.0 or dyn.km_opt == KMOpt.TKE_15:
        raise _unported("the LES TKE closure", SLICE_PHYS)
    if dyn.sppt_amp > 0.0 or dyn.skebs_amp > 0.0:
        raise _unported("SPPT / SKEBS", SLICE_PHYS)
    if dyn.diff_6th_opt:
        raise _unported("the 6th-order filter (diff_6th_opt)", SLICE_PHYS)
    if dyn.fft_filter_lat < 90.0:
        raise _unported("the polar FFT filter", SLICE_REAL)
    if dyn.moist_adv_opt == AdvLimiter.MONOTONIC:
        raise _unported("the monotonic limiter (moist_adv_opt=mono)", SLICE_PHYS)
    orders = (dyn.h_mom_adv_order, dyn.v_mom_adv_order,
              dyn.h_sca_adv_order, dyn.v_sca_adv_order)
    if AdvOrder.WENO5 in orders:
        raise _unported("WENO5 advection", SLICE_PHYS)
    if BCKind.SPECIFIED in (dyn.bc_x, dyn.bc_y):
        raise _unported("specified lateral boundaries", SLICE_REAL)
    if cfg.fdda.grid_fdda:
        raise _unported("analysis nudging (grid_fdda)", SLICE_REAL)
    if cfg.parallel.mesh_x > 1 or cfg.parallel.mesh_y > 1:
        raise _unported("a device mesh", SLICE_MESH)
    if cfg.time_control.ts_points:
        raise _unported("tslist time series", SLICE_REAL)


def check_grid(grid) -> None:
    if grid.has_terrain:
        raise _unported("terrain", SLICE_REAL)
    if grid.curvature:
        raise _unported("map projections", SLICE_REAL)
