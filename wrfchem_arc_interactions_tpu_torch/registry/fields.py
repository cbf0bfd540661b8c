"""Declarative field-spec table — the WRF Registry equivalent (port of the
JAX package's `registry/fields.py`).

Ported: the dynamical core state, the moist scalars (Kessler's three or
Morrison's twelve), the surface fields every configuration carries, the
radiation fields (held heating rates, surface and TOA fluxes, cloud
fraction), the chem tracers of the MOSAIC 4- and 8-bin packages (with the
cloud-borne phase under ``cldchem_onoff`` and the CBM-Z gases for the
``cbmz_`` packages) and the aerosol optical arrays, the convective rain, the surface-layer and PBL
fields, the Noah soil state, the stochastic-physics patterns and the TKE
closures' prognostic `tke` and `qke`.  A configuration the port does not
carry is refused by `utils.support.check_config` before any table is built.

Layout: 3D fields are (z, y, x); "zs" is the staggered vertical axis of
length nz+1 (w levels); `extra` adds leading axes (the band axis of the
aerosol optical arrays, the soil axis of the Noah state).  Horizontal staggering does not change array sizes:
u[k, j, i] lives at the west face of mass cell i, v[k, j, i] at the south
face of cell j.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from wrfchem_arc_interactions_tpu_torch.chem.gas import GAS_SPECIES
from wrfchem_arc_interactions_tpu_torch.chem.mosaic.bins import AER_SPECIES
from wrfchem_arc_interactions_tpu_torch.config import ChemConfig, Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import (
    ChemOpt, CUScheme, KMOpt, PBLScheme, RAScheme, SFScheme, SFSurface,
)
from wrfchem_arc_interactions_tpu_torch.physics.radiation.bands import NBND_LW, NBND_SW
from wrfchem_arc_interactions_tpu_torch.utils.support import check_config

DIMS_ZYX = ("z", "y", "x")
DIMS_ZSYX = ("zs", "y", "x")
DIMS_YX = ("y", "x")

STAG_NONE = ""
STAG_X = "x"    # x-face point (u)
STAG_Y = "y"    # y-face point (v)
STAG_Z = "z"    # w-level point (w, ph)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    dims: Tuple[str, ...]
    stagger: str = STAG_NONE
    units: str = ""
    description: str = ""
    halo: int = 0            # halo width this field needs
    restart: bool = False    # Registry `r` flag
    history: bool = False    # Registry `h` flag
    advected: bool = False   # member of the scalar-advection set
    positive: bool = False   # PD limiter applies
    extra: Tuple[Tuple[str, int], ...] = ()  # extra leading dims, e.g. (("band", 14),)

    def shape(self, nz: int, ny: int, nx: int) -> Tuple[int, ...]:
        sizes = {"z": nz, "zs": nz + 1, "y": ny, "x": nx}
        return tuple(n for _, n in self.extra) + tuple(sizes[d] for d in self.dims)


def _dyn_fields() -> Tuple[FieldSpec, ...]:
    return (
        FieldSpec("u", DIMS_ZYX, STAG_X, "m s-1", "x-wind at west faces",
                  halo=3, restart=True, history=True),
        FieldSpec("v", DIMS_ZYX, STAG_Y, "m s-1", "y-wind at south faces",
                  halo=3, restart=True, history=True),
        FieldSpec("w", DIMS_ZSYX, STAG_Z, "m s-1", "z-wind at w-levels",
                  halo=2, restart=True, history=True),
        FieldSpec("ph", DIMS_ZSYX, STAG_Z, "m2 s-2",
                  "perturbation geopotential at w-levels",
                  halo=2, restart=True, history=True),
        FieldSpec("t", DIMS_ZYX, STAG_NONE, "K",
                  "perturbation potential temperature (theta - T0)",
                  halo=3, restart=True, history=True),
        FieldSpec("mu", DIMS_YX, STAG_NONE, "Pa",
                  "perturbation dry-air column mass",
                  halo=3, restart=True, history=True),
    )


def _moist_fields(cfg: Config) -> Tuple[FieldSpec, ...]:
    return tuple(
        FieldSpec(q, DIMS_ZYX, STAG_NONE,
                  "kg kg-1" if q.startswith("q") else "kg-1",
                  f"moist scalar {q} (mixing ratio / specific number)",
                  halo=3, restart=True, history=True, advected=True, positive=True)
        for q in cfg.moist_species()
    )


def chem_species(chem: ChemConfig) -> Tuple[str, ...]:
    """Advected chemistry tracer names of the active package: per size bin,
    the masses of so4/no3/nh4/cl/na/oin/bc/oc, aerosol water and number;
    with ``cldchem_onoff`` the cloud-borne (_cw) phase, per bin the eight
    masses and number inside cloud droplets; then the CBM-Z gas species
    (`chem.gas`) for a gas package, or the four condensable precursor gases
    for an aerosol-only one."""
    if chem.chem_opt == ChemOpt.NONE:
        return ()
    nbin = 8 if "8bin" in chem.chem_opt.value else 4
    names = []
    for b in range(1, nbin + 1):
        for s in AER_SPECIES:
            names.append(f"{s}_a{b:02d}")
        names.append(f"water_a{b:02d}")
        names.append(f"num_a{b:02d}")
    if chem.cldchem_onoff:
        for b in range(1, nbin + 1):
            for s in AER_SPECIES:
                names.append(f"{s}_cw{b:02d}")
            names.append(f"num_cw{b:02d}")
    if chem.chem_opt in (ChemOpt.CBMZ_MOSAIC_4BIN, ChemOpt.CBMZ_MOSAIC_8BIN):
        names.extend(GAS_SPECIES)
    else:
        names.extend(("h2so4", "hno3", "nh3", "hcl"))
    return tuple(names)


def _chem_fields(cfg: Config) -> Tuple[FieldSpec, ...]:
    specs = [
        FieldSpec(f"chem_{name}", DIMS_ZYX, STAG_NONE,
                  "ug kg-1" if not name.startswith("num") else "kg-1",
                  f"chem tracer {name}",
                  halo=3, restart=True, history=True, advected=True, positive=True)
        for name in chem_species(cfg.chem)
    ]
    if cfg.chem.chem_opt != ChemOpt.NONE:
        # aerosol optical arrays bridging chem -> radiation (the ARC
        # direct-effect coupling surface; canonical tauaer/waer/gaer/extaerlw)
        specs += [
            FieldSpec("tau_aer_sw", DIMS_ZYX, STAG_NONE, "1",
                      "aerosol optical depth per SW band",
                      extra=(("band", NBND_SW),), restart=True),
            FieldSpec("ssa_aer_sw", DIMS_ZYX, STAG_NONE, "1",
                      "aerosol single-scatter albedo per SW band",
                      extra=(("band", NBND_SW),), restart=True),
            FieldSpec("asy_aer_sw", DIMS_ZYX, STAG_NONE, "1",
                      "aerosol asymmetry parameter per SW band",
                      extra=(("band", NBND_SW),), restart=True),
            FieldSpec("tau_aer_lw", DIMS_ZYX, STAG_NONE, "1",
                      "aerosol absorption optical depth per LW band",
                      extra=(("band", NBND_LW),), restart=True),
        ]
    return tuple(specs)


def _phys_fields(cfg: Config) -> Tuple[FieldSpec, ...]:
    ph = cfg.physics
    specs = [
        FieldSpec("tsk", DIMS_YX, STAG_NONE, "K", "surface skin temperature",
                  restart=True, history=True),
        FieldSpec("rainnc", DIMS_YX, STAG_NONE, "mm",
                  "accumulated grid-scale precipitation", restart=True, history=True),
    ]
    if ph.cu_physics != CUScheme.NONE:
        specs.append(
            FieldSpec("rainc", DIMS_YX, STAG_NONE, "mm",
                      "accumulated convective precipitation",
                      restart=True, history=True))
    if ph.ra_sw_physics != RAScheme.NONE or ph.ra_lw_physics != RAScheme.NONE:
        # radiative theta tendencies are held between radiation calls, like
        # grid%rthraten in the reference
        specs += [
            FieldSpec("rthraten_sw", DIMS_ZYX, STAG_NONE, "K s-1",
                      "SW radiative heating (theta tendency)", restart=True),
            FieldSpec("rthraten_lw", DIMS_ZYX, STAG_NONE, "K s-1",
                      "LW radiative heating (theta tendency)", restart=True),
            FieldSpec("swdown", DIMS_YX, STAG_NONE, "W m-2",
                      "downward SW at surface", restart=True, history=True),
            FieldSpec("glw", DIMS_YX, STAG_NONE, "W m-2",
                      "downward LW at surface", restart=True, history=True),
            FieldSpec("olr", DIMS_YX, STAG_NONE, "W m-2",
                      "outgoing LW at TOA", restart=True, history=True),
            FieldSpec("swupt", DIMS_YX, STAG_NONE, "W m-2",
                      "upward SW at TOA", restart=True, history=True),
            FieldSpec("cldfra", DIMS_ZYX, STAG_NONE, "1",
                      "diagnosed cloud fraction (icloud option)",
                      restart=True, history=True),
        ]
    if ph.bl_pbl_physics != PBLScheme.NONE or ph.sf_sfclay_physics != SFScheme.NONE:
        specs += [
            FieldSpec("hfx", DIMS_YX, STAG_NONE, "W m-2", "surface sensible heat flux",
                      restart=True, history=True),
            FieldSpec("qfx", DIMS_YX, STAG_NONE, "kg m-2 s-1", "surface moisture flux",
                      restart=True, history=True),
            FieldSpec("ust", DIMS_YX, STAG_NONE, "m s-1", "friction velocity",
                      restart=True),
            FieldSpec("pblh", DIMS_YX, STAG_NONE, "m", "PBL height",
                      restart=True, history=True),
            FieldSpec("tmn", DIMS_YX, STAG_NONE, "K", "deep soil temperature",
                      restart=True),
        ]
    if ph.sf_surface_physics == SFSurface.NOAH:
        # Noah 4-layer soil state (canonical TSLB/SMOIS, num_soil_layers=4)
        specs += [
            FieldSpec("tslb", DIMS_YX, STAG_NONE, "K",
                      "soil temperature per layer", extra=(("soil", 4),),
                      restart=True, history=True),
            FieldSpec("smois", DIMS_YX, STAG_NONE, "m3 m-3",
                      "soil moisture per layer", extra=(("soil", 4),),
                      restart=True, history=True),
            FieldSpec("rain_prev", DIMS_YX, STAG_NONE, "mm",
                      "accumulated precip at the previous LSM call "
                      "(for the infiltration rate)", restart=True),
            FieldSpec("snow", DIMS_YX, STAG_NONE, "kg m-2",
                      "snow water equivalent", restart=True, history=True),
            FieldSpec("ivgtyp", DIMS_YX, STAG_NONE, "1",
                      "vegetation class index into the lsm.VEG_* tables",
                      restart=True),
        ]
    if cfg.dynamics.sppt_amp > 0.0 or cfg.dynamics.skebs_amp > 0.0:
        # stochastic-physics pattern state (the physical-space AR(1) patterns)
        specs += [
            FieldSpec("sppt_pattern", DIMS_YX, STAG_NONE, "1",
                      "SPPT random pattern (AR1)", restart=True),
            FieldSpec("skebs_psi", DIMS_YX, STAG_NONE, "1",
                      "SKEBS streamfunction pattern (AR1)", restart=True),
        ]
    if cfg.dynamics.km_opt == KMOpt.TKE_15:
        specs.append(
            FieldSpec("tke", DIMS_ZYX, STAG_NONE, "m2 s-2",
                      "subgrid turbulent kinetic energy", halo=2, restart=True,
                      advected=True, positive=True))
    if ph.bl_pbl_physics == PBLScheme.MYNN:
        # MYNN level-2.5 prognostic QKE = 2*TKE, advected
        specs.append(
            FieldSpec("qke", DIMS_ZYX, STAG_NONE, "m2 s-2",
                      "MYNN QKE (2x turbulent kinetic energy)", halo=3,
                      restart=True, advected=True, positive=True))
    return tuple(specs)


def field_table(cfg: Config) -> Tuple[FieldSpec, ...]:
    """The state table for this configuration, in the reference's order
    (raises for configurations whose fields belong to a later slice)."""
    check_config(cfg)
    return _dyn_fields() + _moist_fields(cfg) + _phys_fields(cfg) + _chem_fields(cfg)
