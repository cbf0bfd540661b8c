"""What the port carries so far, and which slice brings the rest.

The port goes slice by slice (ROADMAP.md, Queue 1).  It carries the
dycore with Smagorinsky diffusion, Kessler and Morrison two-moment
microphysics with aerosol activation, RRTMG SW/LW on the radt alarm, and
the whole chem driver on the chemdt alarm for every package (MOSAIC 4 or 8
bins, alone or with CBM-Z): dry deposition, emissions with plume rise,
Fast-J or gray photolysis, CBM-Z with fixed or adaptive ROS2 steps, the
cloud-borne phase with aqueous chemistry, the MOSAIC aerosol dynamics, wet
scavenging and the aerosol optics fed back to radiation; single device,
ideal flat grid, constant emissions.  Every option outside these raises
`NotImplementedError` naming the slice that brings it, so that nothing runs
silently with a piece missing.
"""

from __future__ import annotations

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import (
    AdvLimiter,
    AdvOrder,
    BCKind,
    CUScheme,
    KMOpt,
    MPScheme,
    PBLScheme,
    RAScheme,
    SFScheme,
    SFSurface,
)

SLICE_PHYS = "a later slice (ROADMAP Queue 1 item 7, remaining physics)"
SLICE_RUN = "a later slice (ROADMAP Queue 1 item 8, run infrastructure)"
SLICE_REAL = "a later slice (ROADMAP Queue 1 item 9, real data and nesting)"
SLICE_MESH = "a later slice (ROADMAP Queue 1 item 10, multi-GPU decomposition)"


def _unported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with {where}")


def check_config(cfg: Config) -> None:
    """Raise `NotImplementedError` for any option the port does not carry."""
    ph, dyn, ch = cfg.physics, cfg.dynamics, cfg.chem
    if RAScheme.SIMPLE in (ph.ra_sw_physics, ph.ra_lw_physics):
        raise _unported("the simple radiation scheme (ra_*_physics=simple)", SLICE_PHYS)
    if ch.aer_op_opt != 1:
        raise NotImplementedError(
            f"aer_op_opt={ch.aer_op_opt}: the reference reads this option nowhere and "
            "always mixes by volume (option 1); the port refuses other values rather "
            "than ignore them")
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
        raise _unported("tslist time series", SLICE_RUN)


def check_grid(grid) -> None:
    if grid.has_terrain:
        raise _unported("terrain", SLICE_REAL)
    if grid.curvature:
        raise _unported("map projections", SLICE_REAL)
