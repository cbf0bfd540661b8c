"""Chemistry orchestrator (port of the JAX package's `chem/driver.py`;
canonical: chem/chem_driver.F).

The operator order is

  1 dry deposition -> 2 emissions -> 3 photolysis -> 4 gas-phase chemistry
  -> 5 cloud chemistry -> 6 aerosol dynamics (nucleation, condensation /
  partitioning, coagulation, moving-center remap) -> 7 wet scavenging ->
  8 optical properties

Ported: stage 1 (`aux.dry_deposition`), stages 3-4 for the CBM-Z packages
(`photolysis.j_scales` or the gray `aux.photolysis_profile`, then
`gas.rate_constants` and `gas.integrate` — on a CUDA tensor the generated
ROS2 kernel — or `gas.integrate_adaptive`), stage 6
(`nucleation.nucleate`, `thermo.partition`, `coag.coagulate`,
`movesect.remap`) and stage 8 (`optics.aerosol_optics`).  Config 3 (fixed
MOSAIC bins, no gas mechanism) runs 1 and 8; config 4 runs 1, 3-4, 6 and 8.
Stages 2, 5 and 7 raise `NotImplementedError` when their switch is on.
Every stage is column- or cell-local: no halos.
"""

from __future__ import annotations

import torch

from wrfchem_arc_interactions_tpu_torch.chem import aux, gas, optics, photolysis
from wrfchem_arc_interactions_tpu_torch.chem.mosaic import coag, movesect, nucleation, thermo
from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import ChemOpt
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import diagnose
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.physics.radiation.driver import (
    JULIAN_DAY, cos_zenith,
)
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import constants as c
from wrfchem_arc_interactions_tpu_torch.utils.support import (
    SLICE_CHEM, unported_chem_stages,
)


def _nbin(cfg: Config) -> int:
    return 8 if "8bin" in cfg.chem.chem_opt.value else 4


def _has_gas(cfg: Config) -> bool:
    return cfg.chem.chem_opt in (ChemOpt.CBMZ_MOSAIC_4BIN, ChemOpt.CBMZ_MOSAIC_8BIN)


def chem_driver(state: State, grid: Grid, cfg: Config, dt: float,
                time_s=0.0, julian_day=JULIAN_DAY) -> State:
    """One chem call of length `dt` on the state.  `time_s` (seconds of UTC
    time since the run's day start) and `julian_day` set the sun for the
    photolysis rates.  (The reference also takes the halo context, which no
    stage reads, and emissions, which are not ported yet.)"""
    if cfg.chem.chem_opt not in (ChemOpt.MOSAIC_4BIN, ChemOpt.CBMZ_MOSAIC_4BIN):
        raise NotImplementedError(
            f"chemistry (chem_opt={cfg.chem.chem_opt.value}) is not ported yet; "
            f"it comes with {SLICE_CHEM}")
    stages = unported_chem_stages(cfg)
    if stages:
        raise NotImplementedError(
            f"chem stages {stages} are not ported yet; they come with {SLICE_CHEM}")
    ch = cfg.chem
    nbin = _nbin(cfg)
    diag = diagnose(state, grid, cfg.moist_species())
    exner = (diag.p_full / c.P0) ** c.RCP
    t_air = diag.theta * exner
    rho_air = 1.0 / (diag.alpha_d * diag.eps_ratio)
    ph_full = grid.phb + state["ph"]
    dz = (ph_full[1:] - ph_full[:-1]) / c.G
    qv = state["qv"] if "qv" in state else torch.zeros_like(t_air)
    qc = state["qc"] if "qc" in state else torch.zeros_like(t_air)
    # relative humidity w.r.t. liquid
    es = 611.2 * torch.exp(c.SVP2 * (t_air - c.SVPT0) / (t_air - c.SVP3))
    qvs = c.EP_2 * es / torch.clamp(diag.p_full - es, min=1.0)
    rh = torch.clamp(qv / torch.clamp(qvs, min=1e-8), 0.0, 1.0)

    chem = {k: v for k, v in state.items() if k.startswith("chem_")}

    # 1. dry deposition (resistance-in-series when the surface scheme
    # provides a friction velocity)
    if ch.drydep_opt:
        chem = aux.dry_deposition(chem, dz[0], dt, gas.GAS_SPECIES,
                                  ust=state.get("ust"), nbin=nbin)

    # 3-4. photolysis profile (coupled to the computed cloud and aerosol
    # optical state — the chem->J ARC pathway) + gas-phase mechanism
    if ch.gaschem_onoff and _has_gas(cfg):
        mu0 = cos_zenith(time_s, grid.xlat, grid.xlong, julian_day=julian_day)
        if int(ch.phot_opt) >= 2:
            # Fast-J-style spectral actinic flux: prognostic O3 absorption,
            # Rayleigh, cloud LWP, and the chem-computed aerosol optical
            # state per band -> per-reaction J scales
            j_scale = photolysis.j_scales(
                mu0, rho_air * c.G * dz, chem["chem_o3"] * 1e-6, qc * rho_air * dz,
                state.get("tau_aer_sw"), state.get("ssa_aer_sw"),
                state.get("asy_aer_sw"))
        else:
            # bulk gray attenuation; near-UV aerosol extinction band 10 =
            # 0.345-0.442 um of the SW grid
            tau_uv = state["tau_aer_sw"][10] if "tau_aer_sw" in state else None
            j_scale = aux.photolysis_profile(mu0, qc, rho_air, dz, tau_uv)
        # ppmv -> molec/cm3
        m_air = diag.p_full / (1.380649e-23 * t_air) * 1e-6
        shape = t_air.shape
        conc = torch.stack([chem[f"chem_{s}"] * 1e-6 * m_air
                            for s in gas.GAS_SPECIES]).reshape(gas.NS, -1)
        k_rxn = gas.rate_constants(t_air, m_air, j_scale).reshape(gas.NR_RXN, -1)
        if ch.gas_adaptive:
            conc = gas.integrate_adaptive(conc, k_rxn, dt,
                                          rtol=ch.gas_rtol, atol=ch.gas_atol)
        else:
            conc = gas.integrate(conc, k_rxn, dt)
        conc = conc.reshape((gas.NS,) + shape)
        for i, s in enumerate(gas.GAS_SPECIES):
            chem[f"chem_{s}"] = conc[i] / m_air * 1e6

    # 6. aerosol dynamics
    if ch.aerchem_onoff:
        chem = nucleation.nucleate(chem, rho_air, rh, nbin, dt)
        chem = thermo.partition(chem, t_air, rho_air, rh, nbin, dt)
        chem = coag.coagulate(chem, rho_air, nbin, dt)
        # moving-center bin remap: growth moves particles between sections
        chem = movesect.remap(chem, nbin)

    # 8. aerosol optical properties (the ARC direct-effect bridge)
    out = dict(state)
    out.update(chem)
    if ch.aer_ra_feedback or "tau_aer_sw" in state:
        out.update(optics.aerosol_optics(chem, rho_air, dz, nbin))
    return out
