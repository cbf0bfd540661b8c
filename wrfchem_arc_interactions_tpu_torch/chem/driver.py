"""Chemistry orchestrator (port of the JAX package's `chem/driver.py`;
canonical: chem/chem_driver.F), for the stages of BASELINE config 3.

The reference's operator order is

  dry deposition -> emissions -> photolysis -> gas-phase chemistry ->
  cloud chemistry -> aerosol dynamics -> wet scavenging -> optical
  properties

and config 3 (fixed MOSAIC bins, no gas mechanism) runs dry deposition and
the optical properties.  Every other stage raises `NotImplementedError`
naming slice 3 when its switch is on.  Every stage is column- or
cell-local: no halos.
"""

from __future__ import annotations

from wrfchem_arc_interactions_tpu_torch.chem import aux, optics
from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import ChemOpt
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import diagnose
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import constants as c
from wrfchem_arc_interactions_tpu_torch.utils.support import (
    SLICE_CHEM, unported_chem_stages,
)


NBIN = 4     # MOSAIC_4BIN


def chem_driver(state: State, grid: Grid, cfg: Config, dt: float) -> State:
    """One chem call of length `dt` on the state: dry deposition, then the
    aerosol optical properties.  (The reference also takes the halo
    context, the solar time and emissions, which only the stages of slice 3
    read.)"""
    if cfg.chem.chem_opt != ChemOpt.MOSAIC_4BIN:
        raise NotImplementedError(
            f"chemistry (chem_opt={cfg.chem.chem_opt.value}) is not ported yet; "
            f"it comes with {SLICE_CHEM}")
    stages = unported_chem_stages(cfg)
    if stages:
        raise NotImplementedError(
            f"chem stages {stages} are not ported yet; they come with {SLICE_CHEM}")
    ch = cfg.chem
    diag = diagnose(state, grid, cfg.moist_species())
    rho_air = 1.0 / (diag.alpha_d * diag.eps_ratio)
    ph_full = grid.phb + state["ph"]
    dz = (ph_full[1:] - ph_full[:-1]) / c.G

    chem = {k: v for k, v in state.items() if k.startswith("chem_")}

    # 1. dry deposition (resistance-in-series when the surface scheme
    # provides a friction velocity)
    if ch.drydep_opt:
        chem = aux.dry_deposition(chem, dz[0], dt, aux.GAS_SPECIES,
                                  ust=state.get("ust"), nbin=NBIN)

    # 8. aerosol optical properties (the ARC direct-effect bridge)
    out = dict(state)
    out.update(chem)
    if ch.aer_ra_feedback or "tau_aer_sw" in state:
        out.update(optics.aerosol_optics(chem, rho_air, dz, NBIN))
    return out
