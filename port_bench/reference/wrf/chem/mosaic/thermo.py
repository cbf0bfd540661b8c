"""MOSAIC aerosol thermodynamics — gas-particle partitioning and water
uptake (port of the JAX package's `chem/mosaic/thermo.py`; canonical:
chem/module_mosaic_therm.F MESA/ASTEM).

The canonical MESA/ASTEM is an iterative per-cell solver with
data-dependent iteration counts; this formulation is fixed-work and
branchless:

- **Aerosol water** by kappa-Kohler/ZSR: V_w = V_dry kappa_mix RH/(1-RH).
- **H2SO4**: irreversible kinetic condensation with Fuchs-Sutugin
  transition-regime mass transfer per bin, integrated analytically
  (exponential decay of the gas over dt; bin shares ~ per-bin uptake
  coefficients) — the ASTEM non-volatile pathway.
- **NH3**: condenses toward sulfate neutralisation (NH4)2SO4,
  rate-limited by the same kinetic coefficients.
- **NH4NO3 (+ NaCl displacement)**: ASTEM dynamic mode — per-bin KINETIC
  NO3/NH4 condensation-evaporation toward the bin-local equilibrium
  Kp_b(T, Kelvin(d_b), MESA phase), fixed ASTEM_SUBSTEPS sub-stepping
  (astem_semivolatile; canonical module_mosaic_therm.F ASTEM, Zaveri et
  al. 2008).  HNO3 condensing on sea salt displaces Cl as HCl.

All quantities are (nz, ny, nx) fields; gases in ppmv, aerosol in ug/kg.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from port_bench.reference.wrf.chem.mosaic import bins as mbins

D_GAS = 9.4e-6        # H2SO4 vapor diffusivity [m2/s]
LAMBDA_AIR = 6.5e-8   # mean free path at stp [m]
ACCOM = 0.65          # accommodation coefficient
MW_AIR_G = 28.966


def ppmv_to_ugkg(x_ppmv, mw):
    return x_ppmv * 1e3 * mw / MW_AIR_G      # 1 ppmv = mw/Mair * 1e-6 kg/kg = ... ug/kg


def ugkg_to_ppmv(x_ugkg, mw):
    return x_ugkg * MW_AIR_G / (mw * 1e3)


def uptake_coeffs(chem: Dict[str, torch.Tensor], rho_air, nbin: int,
                  with_diameters: bool = False):
    """Per-bin kinetic uptake coefficient k_b [1/s] for gas condensation:
    k_b = 2 pi D_g D_wet N_b beta(Kn) with Fuchs-Sutugin beta.

    ``with_diameters=True`` additionally returns the wet diameters [m]
    (the ASTEM Kelvin-term input)."""
    ks = []
    ds = []
    for b in range(1, nbin + 1):
        vol = None
        for s in list(mbins.AER_SPECIES) + ["water"]:
            v = chem[f"chem_{s}_a{b:02d}"] * 1e-9 / mbins.DENSITY[s]
            vol = v if vol is None else vol + v
        num = torch.clamp(chem[f"chem_num_a{b:02d}"], min=1.0)     # #/kg
        d_wet = torch.clamp((6.0 * torch.clamp(vol, min=1e-30)
                          / (np.pi * num)) ** (1.0 / 3.0), 1e-9, 50e-6)
        kn = 2.0 * LAMBDA_AIR / d_wet
        beta = (1.0 + kn) / (1.0 + kn * (1.71 + 1.33 * kn) / ACCOM)
        n_m3 = num * rho_air
        ks.append(2.0 * np.pi * D_GAS * d_wet * n_m3 * beta)
        ds.append(d_wet)
    if with_diameters:
        return ks, ds
    return ks                                                   # list of (nz,ny,nx)


# legacy per-species DRH (still used by the generic fallback paths)
DRH = {"so4": 0.80, "nh4": 0.80,    # (NH4)2SO4
       "no3": 0.62,                 # NH4NO3
       "cl": 0.75, "na": 0.75,      # NaCl
       "oin": 0.95, "bc": 1.01, "oc": 0.85}

# --- MESA electrolyte system (canonical: module_mosaic_therm.F's
# electrolyte speciation + MDRH tables).  Ions pair
# into electrolytes by the MESA precedence ladder; each electrolyte has a
# laboratory deliquescence RH at 298 K.  Dust calcium/carbonate are carried
# as fixed fractions of the OIN (other-inorganics) proxy species — the
# standard WRF-Chem treatment where mineral CaCO3 rides inside OIN.
ELECTROLYTE_DRH = {
    "nh42so4": 0.80, "nh4hso4": 0.40, "h2so4": 0.05, "nh4no3": 0.62,
    "nh4cl": 0.77, "na2so4": 0.84, "nahso4": 0.52, "nano3": 0.74,
    "nacl": 0.75, "caso4": 1.0, "cano32": 0.49, "caco3": 1.0,
    "oc": 0.85,
}
# moles of Ca / CO3 per gram of OIN (dust carbonate content ~5% by mass
# as CaCO3, MW 100)
OIN_CACO3_MASS_FRAC = 0.05


# crystallization (efflorescence) RH: the lower hysteresis branch sits far
# below deliquescence (canonical: (NH4)2SO4 effloresces near 35% RH)
CRH_FRACTION = 0.45          # CRH ~ 0.45 * DRH of the mix


def electrolyte_ladder(ions: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """MESA electrolyte speciation: pair cation/anion mole concentrations
    into electrolyte moles by the precedence ladder (canonical MESA
    ordering: CaSO4 -> CaCO3 -> Na2SO4 -> ammonium sulfates -> Ca(NO3)2 ->
    NaNO3 -> NaCl -> NH4NO3 -> NH4Cl).  Ion conservation is exact by
    construction (each pairing consumes min(available) on both sides) —
    pinned by tests/test_mesa_electrolytes.py."""
    z = dict(ions)
    e = {}

    def take(name, cat, an, n_cat=1.0, n_an=1.0):
        amt = torch.clamp(z[cat] / n_cat, max=z[an] / n_an)
        e[name] = amt
        z[cat] = z[cat] - n_cat * amt
        z[an] = z[an] - n_an * amt

    take("caso4", "ca", "so4")
    take("caco3", "ca", "co3")
    take("na2so4", "na", "so4", n_cat=2.0)
    take("nh42so4", "nh4", "so4", n_cat=2.0)
    take("nh4hso4", "nh4", "so4")          # sulfate-rich residual
    e["h2so4"] = z["so4"]                  # fully acidic leftover
    z["so4"] = torch.zeros_like(z["so4"])
    take("cano32", "ca", "no3", n_an=2.0)
    take("nano3", "na", "no3")
    take("nacl", "na", "cl")
    take("nh4no3", "nh4", "no3")
    take("nh4cl", "nh4", "cl")
    # unpaired residuals (excess base as NaOH-like, excess acid as
    # HNO3/HCl-like, free NH3-like ammonium, leftover dust carbonate) —
    # kept explicitly so ion conservation is exact
    e["_residual_na"] = z["na"]
    e["_residual_ca"] = z["ca"]
    e["_residual_nh4"] = z["nh4"]
    e["_residual_no3"] = z["no3"]
    e["_residual_cl"] = z["cl"]
    e["_residual_co3"] = z["co3"]
    return e


def bin_ions(chem: Dict[str, torch.Tensor], b: int) -> Dict[str, torch.Tensor]:
    """Ion mole concentrations [umol/kg-air] of bin b, with dust Ca/CO3
    derived from the OIN proxy."""
    g = lambda s: chem[f"chem_{s}_a{b:02d}"]
    caco3_mol = g("oin") * OIN_CACO3_MASS_FRAC / 100.09
    return {
        "so4": g("so4") / mbins.MW["so4"],
        "no3": g("no3") / mbins.MW["no3"],
        "nh4": g("nh4") / mbins.MW["nh4"],
        "na": g("na") / mbins.MW["na"],
        "cl": g("cl") / mbins.MW["cl"],
        "ca": caco3_mol,
        "co3": caco3_mol,
    }


def mutual_drh(chem: Dict[str, torch.Tensor], b: int):
    """Mixture deliquescence RH of bin b from the electrolyte speciation.

    The mole-fraction-weighted mean over soluble electrolytes, reduced
    toward the eutonic point by a mixing-entropy factor
    (1 - 0.3*(1 - sum x_i^2)): pure bins keep the laboratory DRH, mixed
    bins deliquesce below every member's DRH — the shape of the
    reference's MDRH lookup tables without their 60-entry enumeration."""
    e = electrolyte_ladder(bin_ions(chem, b))
    oc_mol = chem[f"chem_oc_a{b:02d}"] / mbins.MW["oc"]
    mol_tot = oc_mol
    drh_mol = ELECTROLYTE_DRH["oc"] * oc_mol
    x2 = None
    soluble = [(k, v) for k, v in e.items()
               if not k.startswith("_") and ELECTROLYTE_DRH.get(k, 1.0) < 1.0]
    for k, v in soluble:
        mol_tot = mol_tot + v
        drh_mol = drh_mol + ELECTROLYTE_DRH[k] * v
    mol_safe = torch.clamp(mol_tot, min=1e-30)
    for k, v in soluble + [("oc", oc_mol)]:
        xi2 = (v / mol_safe) ** 2
        x2 = xi2 if x2 is None else x2 + xi2
    mean_drh = drh_mol / mol_safe
    eutonic = 1.0 - 0.3 * (1.0 - x2)
    drh = mean_drh * eutonic
    # a bin with no soluble material never deliquesces
    return torch.where(mol_tot > 1e-30, drh, 1.01)


def phase_state(chem: Dict[str, torch.Tensor], rh, nbin: int):
    """MESA-style solid/liquid phase flag per bin WITH the deliquescence/
    efflorescence hysteresis branch (canonical: module_mosaic_therm.F MESA
    jhyst_leg logic).

    - RH above the mutual DRH of the bin's ELECTROLYTE mix (speciated by
      the MESA ladder, `mutual_drh`): liquid.
    - RH below the crystallization RH (CRH ~ 0.45 DRH): solid.
    - In between, the phase is HISTORY-dependent: a particle that was wet
      stays wet (the metastable upper branch).  The history carrier is the
      prognostic aerosol water itself (chem_water_aXX > 0 from the previous
      chemistry step — advected with the bin, exactly like the reference's
      hysteresis water), so the branch survives transport and restart.

    Returns a list of (nz, ny, nx) liquid fractions in {0, 1}."""
    flags = []
    for b in range(1, nbin + 1):
        dry_mass = None
        for s in mbins.AER_SPECIES:
            dry_mass = (chem[f"chem_{s}_a{b:02d}"] if dry_mass is None
                        else dry_mass + chem[f"chem_{s}_a{b:02d}"])
        drh_mix = mutual_drh(chem, b)
        crh_mix = CRH_FRACTION * drh_mix
        was_wet = chem.get(f"chem_water_a{b:02d}")
        if was_wet is None:
            on_upper_branch = torch.zeros_like(rh)
        else:
            # "was wet": carried water exceeding a trace of the dry mass
            on_upper_branch = (was_wet > 1e-3 * torch.clamp(dry_mass, min=1e-30)
                               ).to(rh.dtype)
        liquid = torch.where(rh > drh_mix, 1.0,
                           torch.where(rh > crh_mix, on_upper_branch, 0.0))
        flags.append(liquid.to(rh.dtype))
    return flags


def water_uptake(chem: Dict[str, torch.Tensor], rh, nbin: int) -> Dict[str, torch.Tensor]:
    """kappa-Kohler aerosol water per bin: V_w = V_dry kappa RH/(1-RH),
    gated by the MESA phase state (solid bins carry no water)."""
    out = {}
    aw = torch.clamp(rh, 0.05, 0.98)
    liquid = phase_state(chem, rh, nbin)
    for b in range(1, nbin + 1):
        v_dry = None
        v_kappa = None
        for s in mbins.AER_SPECIES:
            v = chem[f"chem_{s}_a{b:02d}"] * 1e-9 / mbins.DENSITY[s]
            v_dry = v if v_dry is None else v_dry + v
            kv = mbins.KAPPA[s] * v
            v_kappa = kv if v_kappa is None else v_kappa + kv
        v_w = v_kappa * aw / (1.0 - aw) * liquid[b - 1]
        out[f"chem_water_a{b:02d}"] = v_w * mbins.DENSITY["water"] * 1e9  # ug/kg
    return out


def mozurkewich_kp(t_air):
    """NH4NO3 dissociation constant [ppb^2] (Mozurkewich 1993)."""
    return torch.exp(118.87 - 24084.0 / t_air - 6.025 * torch.log(t_air))


# ASTEM fixed sub-stepping: the reference's adaptive step count becomes a
# constant (a fixed-iteration batched form);
# 6 sub-steps of chemdt/6 resolve the stiff early transient to within a few
# percent of a dense f64 integration (tests/test_astem.py convergence test).
ASTEM_SUBSTEPS = 6
SIGMA_AER = 0.08          # surface tension of the aqueous aerosol [N/m]


def astem_semivolatile(out: Dict[str, torch.Tensor], t_air, rh,
                       ks, d_wets, liquid, nbin: int, dt: float):
    """ASTEM dynamic mode: per-bin kinetic NO3/NH4 condensation-evaporation
    toward bin-local NH4NO3 equilibrium (canonical: the ASTEM semi-volatile
    solver of module_mosaic_therm.F, Zaveri et al. 2008 JGR).

    Per bin b the HNO3 flux is dC/dt = k_b (C_HNO3 - C_eq,b) with the
    surface equilibrium C_eq,b = Kp_b / C_NH3, where

      Kp_b = Kp(T) * kelvin_b * (0.1 if liquid else 1)

    — Kp from Mozurkewich, the Kelvin factor exp(4 sigma Mw/(R T rho_w
    d_wet,b)) penalising small bins, and the deliquesced-branch activity
    reduction gated by the MESA phase state per bin.  NH4 follows NO3 1:1
    (molar).  NaCl displacement chemistry rides the same flux: HNO3
    condensing into a bin with sea salt displaces Cl as HCl gas
    (HNO3 + NaCl -> NaNO3 + HCl), bounded by the bin's Cl and Na content.

    Fixed ASTEM_SUBSTEPS explicit sub-steps with per-substep relaxation
    factors (1 - exp(-k_b dt_s)) and a global gas-availability limiter —
    branchless, fixed work, decomposition-invariant.  Mutates ``out``.
    """
    kp0 = mozurkewich_kp(t_air)                     # ppb^2
    kelvin = [torch.exp(4.0 * SIGMA_AER * 18.015e-3
                      / (8.314 * t_air * 1000.0 * torch.clamp(d, min=1e-9)))
              for d in d_wets]
    kp_b = [kp0 * kelvin[b] * torch.where(liquid[b] > 0.5, 0.1, 1.0)
            for b in range(nbin)]

    nh3_ppb = out["chem_nh3"] * 1e3
    hno3_ppb = out["chem_hno3"] * 1e3
    hcl_ppb = out["chem_hcl"] * 1e3 if "chem_hcl" in out else None
    no3_b = [out[f"chem_no3_a{b:02d}"] for b in range(1, nbin + 1)]
    nh4_b = [out[f"chem_nh4_a{b:02d}"] for b in range(1, nbin + 1)]
    cl_b = [out.get(f"chem_cl_a{b:02d}") for b in range(1, nbin + 1)]
    na_b = [out.get(f"chem_na_a{b:02d}") for b in range(1, nbin + 1)]

    dts = dt / ASTEM_SUBSTEPS
    relax = [1.0 - torch.exp(-k * dts) for k in ks]
    mw_no3, mw_nh4, mw_cl = mbins.MW["no3"], mbins.MW["nh4"], mbins.MW["cl"]

    for _ in range(ASTEM_SUBSTEPS):
        nh3_safe = torch.clamp(nh3_ppb, min=1e-6)
        # per-bin driving force in HNO3 ppb
        d_raw = [relax[b] * (hno3_ppb - kp_b[b] / nh3_safe)
                 for b in range(nbin)]
        # evaporation bounded by the bin's particulate NO3 (in ppb)
        no3_ppb_b = [ugkg_to_ppmv(no3_b[b], mw_no3) * 1e3
                     for b in range(nbin)]
        d_lim = [torch.clamp(d_raw[b], min=-no3_ppb_b[b]) for b in range(nbin)]
        # condensation bounded by the gas pool AND the NH3 companion pool:
        # scale all positive fluxes by the common availability factor
        pos_sum = sum(torch.clamp(d, min=0.0) for d in d_lim)
        gas_avail = torch.clamp(hno3_ppb, max=nh3_ppb)
        scale = torch.clamp(gas_avail / torch.clamp(pos_sum, min=1e-30), 0.0, 1.0)
        d_fin = [torch.where(d > 0, d * scale, d) for d in d_lim]

        d_tot = sum(d_fin)
        hno3_ppb = torch.clamp(hno3_ppb - d_tot, min=0.0)
        for b in range(nbin):
            d_ug = ppmv_to_ugkg(d_fin[b] * 1e-3, mw_no3)
            # NaCl displacement: the condensing-HNO3 share that lands on
            # sea salt evicts Cl (molar 1:1), up to the available Cl
            if cl_b[b] is not None and na_b[b] is not None \
                    and hcl_ppb is not None:
                cond_mol = torch.clamp(d_ug, min=0.0) / mw_no3
                salt_mol = torch.clamp(cl_b[b] / mw_cl, max=na_b[b] / mbins.MW["na"])
                d_cl_mol = torch.clamp(cond_mol, max=torch.clamp(salt_mol, min=0.0))
                cl_b[b] = cl_b[b] - d_cl_mol * mw_cl
                hcl_ppb = hcl_ppb + ugkg_to_ppmv(d_cl_mol * mw_cl,
                                                 mw_cl) * 1e3
                # the displaced fraction forms NaNO3 (no NH4 companion)
                nh4_companion_mol = torch.clamp(d_ug, min=0.0) / mw_no3 - d_cl_mol
            else:
                nh4_companion_mol = torch.clamp(d_ug, min=0.0) / mw_no3
            # evaporation releases the NH4 companion too (NH4NO3 -> gases)
            evap_mol = torch.clamp(d_ug, max=0.0) / mw_no3
            d_nh4_ug = (nh4_companion_mol + evap_mol) * mw_nh4
            # companion NH4 bounded by the bin's NH4 on evaporation
            d_nh4_ug = torch.clamp(d_nh4_ug, min=-nh4_b[b])
            no3_b[b] = torch.clamp(no3_b[b] + d_ug, min=0.0)
            nh4_b[b] = torch.clamp(nh4_b[b] + d_nh4_ug, min=0.0)
            nh3_ppb = torch.clamp(nh3_ppb - ugkg_to_ppmv(d_nh4_ug, mw_nh4) * 1e3, min=0.0)

    out["chem_nh3"] = nh3_ppb * 1e-3
    out["chem_hno3"] = hno3_ppb * 1e-3
    if hcl_ppb is not None:
        out["chem_hcl"] = hcl_ppb * 1e-3
    for b in range(1, nbin + 1):
        out[f"chem_no3_a{b:02d}"] = no3_b[b - 1]
        out[f"chem_nh4_a{b:02d}"] = nh4_b[b - 1]
        if cl_b[b - 1] is not None:
            out[f"chem_cl_a{b:02d}"] = torch.clamp(cl_b[b - 1], min=0.0)
    return out


def partition(chem: Dict[str, torch.Tensor], t_air, rho_air, rh,
              nbin: int, dt: float) -> Dict[str, torch.Tensor]:
    """One chemdt of gas-particle mass transfer. Returns updated fields."""
    out = dict(chem)
    ks, d_wets = uptake_coeffs(chem, rho_air, nbin, with_diameters=True)
    k_tot = sum(ks)
    k_tot_safe = torch.clamp(k_tot, min=1e-30)
    frac = [k / k_tot_safe for k in ks]
    transfer = 1.0 - torch.exp(-k_tot * dt)      # fraction of gas taken up

    # --- H2SO4: irreversible condensation --------------------------------
    h2so4 = chem["chem_h2so4"]                                   # ppmv
    dh = h2so4 * transfer
    out["chem_h2so4"] = h2so4 - dh
    dso4_ug = ppmv_to_ugkg(dh, mbins.MW["so4"])
    for b in range(1, nbin + 1):
        key = f"chem_so4_a{b:02d}"
        out[key] = chem[key] + dso4_ug * frac[b - 1]

    # --- NH3 -> neutralise sulfate (2 NH4 : 1 SO4 target) ----------------
    nh3 = chem["chem_nh3"]
    so4_tot = sum(out[f"chem_so4_a{b:02d}"] for b in range(1, nbin + 1))
    nh4_tot = sum(chem[f"chem_nh4_a{b:02d}"] for b in range(1, nbin + 1))
    so4_mol = so4_tot / mbins.MW["so4"]
    nh4_mol = nh4_tot / mbins.MW["nh4"]
    deficit_mol = torch.clamp(2.0 * so4_mol - nh4_mol, min=0.0)      # umol-ish/kg
    nh3_avail_mol = ppmv_to_ugkg(nh3, mbins.MW["nh4"]) / mbins.MW["nh4"]
    dnh4_mol = torch.clamp(deficit_mol, max=nh3_avail_mol * transfer)
    dnh4_ug = dnh4_mol * mbins.MW["nh4"]
    out["chem_nh3"] = nh3 - ugkg_to_ppmv(dnh4_ug, mbins.MW["nh4"])
    for b in range(1, nbin + 1):
        key = f"chem_nh4_a{b:02d}"
        out[key] = chem[key] + dnh4_ug * frac[b - 1]

    # --- NH4NO3 (+ NaCl displacement): ASTEM per-bin kinetic dynamics ----
    liquid = phase_state(chem, rh, nbin)
    out = astem_semivolatile(out, t_air, rh, ks, d_wets, liquid, nbin, dt)

    # --- water equilibrium ----------------------------------------------
    out.update(water_uptake(out, rh, nbin))
    return out
