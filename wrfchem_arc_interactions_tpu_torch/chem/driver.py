"""Chemistry orchestrator (port of the JAX package's `chem/driver.py`;
canonical: chem/chem_driver.F).

The operator order is

  1 dry deposition -> 2 emissions -> 3 photolysis -> 4 gas-phase chemistry
  -> 5 cloud chemistry -> 6 aerosol dynamics (nucleation, condensation /
  partitioning, coagulation, moving-center remap) -> 7 wet scavenging ->
  8 optical properties

Every stage is ported, for the 4- and the 8-bin MOSAIC packages alone or
with CBM-Z: 1 `aux.dry_deposition`; 2 (``emiss_opt``, with an emissions
dict) `aux.apply_emissions`, with `aux.plume_rise_profile` for elevated
``elev_`` sources; 3-4 for the CBM-Z packages `photolysis.j_scales` or the
gray `aux.photolysis_profile`, then `gas.rate_constants` and
`gas.integrate` (on a CUDA tensor the generated ROS2 kernel) or
`gas.integrate_adaptive`; 5 (``cldchem_onoff``) `aux.cw_exchange` and
`aux.cloud_chemistry`; 6 `nucleation.nucleate`, `thermo.partition`,
`coag.coagulate`, `movesect.remap`; 7 (``wetscav_onoff``)
`aux.wet_scavenging`; 8 `optics.aerosol_optics` (the Mie kernel once per
bin).  Config 3 (fixed MOSAIC bins, no gas mechanism) runs 1 and 8; config
4 runs 1, 3-4, 6 and 8.  Every stage is column- or cell-local: no halos.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.chem import aux, gas, optics, photolysis
from wrfchem_arc_interactions_tpu_torch.chem.mosaic import coag, movesect, nucleation, thermo
from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import ChemOpt
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import diagnose
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.grid.grid import TENSOR_FIELDS
from wrfchem_arc_interactions_tpu_torch.physics.radiation import bands as rbands
from wrfchem_arc_interactions_tpu_torch.physics.radiation.driver import (
    JULIAN_DAY, cos_zenith,
)
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import constants as c
from wrfchem_arc_interactions_tpu_torch.utils import trace
from wrfchem_arc_interactions_tpu_torch.utils.device import pass_slices


def _nbin(cfg: Config) -> int:
    return 8 if "8bin" in cfg.chem.chem_opt.value else 4


def _has_gas(cfg: Config) -> bool:
    return cfg.chem.chem_opt in (ChemOpt.CBMZ_MOSAIC_4BIN, ChemOpt.CBMZ_MOSAIC_8BIN)


def row_blocks(ny: int, nx: int, nz: int) -> List[Tuple[int, int]]:
    """The (y0, y1) row blocks a chem call over (nz, ny, nx) cells runs in
    (`utils.device.pass_slices`): its largest temporaries are the aerosol
    optics' (band, level, column) fields of one bin, at all SW and LW
    bands."""
    return pass_slices(ny, nx * nz * (rbands.NBND_SW + rbands.NBND_LW))


def _rows(fields, ny: int, nx: int, y0: int, y1: int):
    """Rows y0..y1-1 of every tensor whose trailing axes are (ny, nx), as
    contiguous copies; anything else whole."""
    return {k: v[..., y0:y1, :].contiguous()
            if isinstance(v, torch.Tensor) and v.dim() >= 2 and tuple(v.shape[-2:]) == (ny, nx)
            else v for k, v in fields.items()}


def chem_driver(state: State, grid: Grid, cfg: Config, dt: float,
                time_s=0.0, emissions: Optional[Dict[str, torch.Tensor]] = None,
                julian_day=JULIAN_DAY) -> State:
    """One chem call of length `dt` on the state.  `time_s` (seconds of UTC
    time since the run's day start) and `julian_day` set the sun for the
    photolysis rates.  `emissions` ({species or ``elev_`` species: (ny, nx)
    flux, ``heat_mw``: (ny, nx)}) feed stage 2 under ``emiss_opt``.  (The
    reference also takes the halo context, which no stage reads.)

    Every stage is column-local, so a domain whose temporaries would pass
    `utils.device.PASS_ELEMENTS` runs in blocks of rows (`row_blocks`), each
    as a domain of its own, and its fields are joined again, with the
    transient memory of one block: the same result bit for bit on the card,
    and on the CPU where each block holds a multiple of 32 columns (there
    PyTorch computes the last n mod 32 elements of an elementwise exp, log
    or pow in a scalar loop that rounds differently)."""
    ny, nx = grid.ny, grid.nx
    blocks = row_blocks(ny, nx, state["t"].shape[0])
    if len(blocks) == 1:
        with trace.span("row_block"):
            return _chem_columns(state, grid, cfg, dt, time_s, emissions, julian_day)
    out = dict(state)
    written: Dict[str, torch.Tensor] = {}
    for y0, y1 in blocks:
        with trace.span("row_block"):
            part_state = _rows(state, ny, nx, y0, y1)
            part_grid = dataclasses.replace(grid, **_rows(
                {k: getattr(grid, k) for k in TENSOR_FIELDS}, ny, nx, y0, y1))
            part = _chem_columns(part_state, part_grid, cfg, dt, time_s,
                                 None if emissions is None else _rows(emissions, ny, nx, y0, y1),
                                 julian_day)
            for k, v in part.items():
                if v is part_state.get(k):
                    continue
                if k not in written:
                    written[k] = torch.empty(v.shape[:-2] + (ny, nx), dtype=v.dtype,
                                             device=v.device)
                written[k][..., y0:y1, :] = v
            del part, part_state, part_grid
    out.update(written)
    return out


def _chem_columns(state: State, grid: Grid, cfg: Config, dt: float, time_s,
                  emissions: Optional[Dict[str, torch.Tensor]], julian_day) -> State:
    """`chem_driver` on one block of columns."""
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
    qr = state["qr"] if "qr" in state else torch.zeros_like(t_air)
    # relative humidity w.r.t. liquid
    es = 611.2 * torch.exp(c.SVP2 * (t_air - c.SVPT0) / (t_air - c.SVP3))
    qvs = c.EP_2 * es / torch.clamp(diag.p_full - es, min=1.0)
    rh = torch.clamp(qv / torch.clamp(qvs, min=1e-8), 0.0, 1.0)

    chem = {k: v for k, v in state.items() if k.startswith("chem_")}

    # 1. dry deposition (resistance-in-series when the surface scheme
    # provides a friction velocity)
    if ch.drydep_opt:
        with trace.span("drydep"):
            chem = aux.dry_deposition(chem, dz[0], dt, gas.GAS_SPECIES,
                                      ust=state.get("ust"), nbin=nbin)

    # 2. emissions (surface fluxes + Briggs plume rise for elevated `elev_*`
    # sources carrying a `heat_mw` entry)
    if ch.emiss_opt and emissions:
        with trace.span("emissions"):
            plume_w = None
            if any(k.startswith("elev_") for k in emissions):
                z_w = (ph_full - ph_full[0:1]) / c.G
                u_mean = torch.sqrt(state["u"][0] ** 2 + state["v"][0] ** 2)
                heat = emissions["heat_mw"] if "heat_mw" in emissions else torch.ones_like(u_mean)
                plume_w = aux.plume_rise_profile(heat, u_mean, z_w)
            chem = aux.apply_emissions(chem, emissions, rho_air[0], dz[0], dt,
                                       plume_w=plume_w, rho=rho_air, dz=dz)

    # 3-4. photolysis profile (coupled to the computed cloud and aerosol
    # optical state — the chem->J ARC pathway) + gas-phase mechanism
    if ch.gaschem_onoff and _has_gas(cfg):
        with trace.span("photolysis"):
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
        with trace.span("gas"):
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

    # 5. cloud chemistry: activation/resuspension bookkeeping of the
    # cloud-borne (_cw) phase, then aqueous S(IV)->S(VI) into the droplets
    if ch.cldchem_onoff:
        with trace.span("cloud"):
            w_c = 0.5 * (state["w"][:-1] + state["w"][1:])
            chem = aux.cw_exchange(chem, qc, t_air, diag.p_full, rho_air, w_c, nbin)
            chem = aux.cloud_chemistry(chem, qc, t_air, nbin, dt)

    # 6. aerosol dynamics
    if ch.aerchem_onoff:
        with trace.span("aerosol"):
            chem = nucleation.nucleate(chem, rho_air, rh, nbin, dt)
            chem = thermo.partition(chem, t_air, rho_air, rh, nbin, dt)
            chem = coag.coagulate(chem, rho_air, nbin, dt)
            # moving-center bin remap: growth moves particles between sections
            chem = movesect.remap(chem, nbin)

    # 7. wet scavenging (size-resolved per bin: Greenfield-gap collection)
    if ch.wetscav_onoff:
        with trace.span("wetscav"):
            chem = aux.wet_scavenging(chem, qr, dt, gas.GAS_SPECIES, nbin=nbin)

    # 8. aerosol optical properties (the ARC direct-effect bridge)
    out = dict(state)
    out.update(chem)
    if ch.aer_ra_feedback or "tau_aer_sw" in state:
        with trace.span("optics"):
            out.update(optics.aerosol_optics(chem, rho_air, dz, nbin))
    return out
