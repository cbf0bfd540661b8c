"""Auxiliary chemistry processes (port of the JAX package's `chem/aux.py`;
canonical: chem/dry_dep_driver.F, module_aer_drydep.F,
module_phot_fastj.F, emissions_driver.F, module_plumerise1.F,
module_wetscav_driver.F, module_mosaic_wetscav.F, module_mixactivate.F,
module_mosaic_cloudchem.F, module_cmu_bulkaqchem.F):

- dry deposition, a first-order sink in the lowest model layer, with
  species-class deposition velocities when no friction velocity is
  available, or the resistance-in-series velocities when the surface scheme
  provides one;
- the gray photolysis profile (``phot_opt=1``);
- emissions: surface fluxes into the lowest layer, and elevated ``elev_``
  sources spread over the Briggs plume-rise injection layer;
- wet scavenging: size-resolved below-cloud collection of the interstitial
  bins, first-order uptake of soluble gases, and the drain of the
  cloud-borne phase by the cloud-to-rain conversion;
- the cloud-borne (_cw) phase: activation and resuspension between each
  bin's interstitial and cloud-borne shares, and bulk aqueous
  S(IV) -> S(VI) by H2O2 and O3 into the droplets.

A chem field named after a species of `chem.gas.GAS_SPECIES` is treated as
a gas.  Every function returns a new dict of new tensors where it changes a
field: the state's tensors are shared between steps, so none is updated in
place.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from port_bench.reference.wrf.chem.gas import GAS_SPECIES  # noqa: F401
from port_bench.reference.wrf.chem.mosaic import bins as mbins
from port_bench.reference.wrf.chem.mosaic.thermo import ppmv_to_ugkg
from port_bench.reference.wrf.physics.mixactivate import activate_fractions

# fallback deposition velocities [m/s] by species class (used when no
# friction velocity is available)
VDEP = {"o3": 0.004, "hno3": 0.02, "so2": 0.008, "nh3": 0.01, "h2o2": 0.01,
        "no2": 0.002, "pan": 0.002, "hcho": 0.005, "default_gas": 0.002,
        "aerosol": 0.002}

# Wesely (1989) bulk surface (canopy) resistances [s/m]
RC_WESELY = {"o3": 100.0, "so2": 130.0, "hno3": 1.0, "nh3": 80.0,
             "h2o2": 50.0, "no2": 300.0, "no": 3000.0, "pan": 500.0,
             "hcho": 150.0, "co": 1.0e5, "ald2": 300.0, "hono": 50.0,
             "n2o5": 1.0, "hno4": 10.0, "ch3ooh": 200.0, "rooh": 200.0,
             "default_gas": 400.0}
KARMAN = 0.4
Z0_DEP = 0.1           # roughness length [m] (land)


def deposition_velocities(ust, z1, bin_diam_m):
    """Resistance-in-series deposition velocities.

    Gases: vd = 1/(ra + rb + rc) with aerodynamic ra = ln(z1/z0)/(k u*),
    quasi-laminar rb ~ 5/u*, Wesely rc per species.  Aerosol (Slinn):
    vd = vg + 1/(ra + rs + ra rs vg) with gravitational settling vg(D) and
    surface resistance rs = 1/(u*(Sc^-2/3 + 10^(-3/St))).

    Returns ({species: vd_gas (ny,nx)}, [vd_aer per bin]).
    """
    ust = torch.clamp(ust, min=0.05)
    ra = torch.log(torch.clamp(z1, min=2.0 * Z0_DEP) / Z0_DEP) / (KARMAN * ust)
    rb = 5.0 / ust
    vd_gas = {s: 1.0 / (ra + rb + rc) for s, rc in RC_WESELY.items()}

    vd_aer = []
    mu_air = 1.8e-5
    for d in bin_diam_m:
        # Cunningham slip correction (host float64, as in the reference)
        d = float(d)
        kn = 2.0 * 6.5e-8 / d
        cc = 1.0 + kn * (1.257 + 0.4 * math.exp(-1.1 / kn))
        vg = 1500.0 * d ** 2 * 9.81 * cc / (18.0 * mu_air)
        # Brownian Schmidt number + impaction Stokes number
        diff = 1.38e-23 * 293.0 * cc / (3.0 * math.pi * mu_air * d)
        sc = mu_air / (1.2 * diff)
        st = vg * ust ** 2 / (9.81 * mu_air / 1.2)
        rs = 1.0 / (ust * (sc ** (-2.0 / 3.0)
                           + 10.0 ** (-3.0 / torch.clamp(st, min=1e-3))))
        vd_aer.append(vg + 1.0 / (ra + rs + ra * rs * vg))
    return vd_gas, vd_aer


def photolysis_profile(mu0, qc, rho, dz, tau_aer_vis=None):
    """3D J-rate scale coupled to the computed optical state (phot_opt=1).

    Per-layer optical depth = cloud (tau = 150 * LWP_layer, i.e. 3/2 LWP /
    (rho_w r_eff) with r_eff = 10 um) + the chem-computed near-UV aerosol
    extinction profile `tau_aer_vis` (a band of tau_aer_sw).  The actinic
    scale at layer k attenuates with the slant overhead optical depth:
    J ~ mu0 * exp(-0.4 tau_above / max(mu0, 0.2)).  Returns (nz, ny, nx)."""
    tau_lay = 150.0 * qc * rho * dz
    if tau_aer_vis is not None:
        tau_lay = tau_lay + tau_aer_vis
    # overhead OD at layer k = sum of the layers above (k indexes upward)
    od_above = torch.flip(torch.cumsum(torch.flip(tau_lay, (0,)), dim=0), (0,)) - tau_lay
    slant = torch.clamp(od_above, 0.0, 20.0) / torch.clamp(mu0, min=0.2)[None]
    return torch.clamp(mu0, min=0.0)[None] * torch.exp(-0.4 * slant)


def dry_deposition(chem: Dict[str, torch.Tensor], dz0, dt: float,
                   gas_names, ust=None, nbin: int = 4) -> Dict[str, torch.Tensor]:
    """Dry-deposition sink in the lowest model layer; dz0 (ny, nx).

    With a friction velocity, uses the resistance-in-series velocities
    (deposition_velocities); otherwise the fallback class table."""
    out = dict(chem)
    vd_gas = vd_aer = None
    if ust is not None:
        diams = mbins.make_bins(nbin).d_center
        vd_gas, vd_aer = deposition_velocities(ust, 0.5 * dz0, diams)
    for name, arr in chem.items():
        short = name.replace("chem_", "")
        if short in gas_names:
            if vd_gas is not None:
                v = vd_gas.get(short, vd_gas["default_gas"])
            else:
                v = VDEP.get(short, VDEP["default_gas"])
        elif "_a" in short:
            if vd_aer is not None:
                b = int(short[-2:]) - 1
                v = vd_aer[min(b, len(vd_aer) - 1)]
            else:
                v = VDEP["aerosol"]
        else:
            continue
        fac = torch.exp(-v * dt / torch.clamp(dz0, min=1.0))
        new = arr.clone()
        new[0] = arr[0] * fac
        out[name] = new
    return out


# ---------------------------------------------------------------------------
# Plume rise (canonical: chem/module_plumerise1.F, Briggs-style rise of
# buoyant fire/stack emissions into an elevated injection layer)
# ---------------------------------------------------------------------------

def plume_rise_profile(heat_mw, u_mean, z_w):
    """Injection-weight profile for buoyant elevated emissions.

    heat_mw: source heat flux [MW] (ny, nx); u_mean: transport wind [m/s];
    z_w: (nz+1, ny, nx) w-level heights above ground.  Briggs (1975) final
    rise for buoyant plumes in neutral flow, dh ~ 38.7 Fb^(3/5) / u with
    Fb ~ 8.8e-6 * Q[W] m4/s3; emissions spread uniformly between 0.5 dh
    and dh.  Returns (nz, ny, nx) weights summing to 1 per column (all at
    level 0 where the plume stays below the first level)."""
    q_w = torch.clamp(heat_mw, min=1e-3) * 1e6
    fb = 8.8e-6 * q_w
    u = torch.clamp(u_mean, min=1.0)
    dh = 38.7 * fb ** 0.6 / u
    z_top = torch.clamp(dh, 50.0, 8000.0)[None]
    z_bot = 0.5 * z_top
    z_lo = z_w[:-1]
    z_hi = z_w[1:]
    overlap = torch.clamp(torch.minimum(z_hi, z_top) - torch.maximum(z_lo, z_bot), min=0.0)
    total = torch.sum(overlap, dim=0, keepdim=True)
    w = overlap / torch.clamp(total, min=1.0)
    w0 = torch.zeros_like(w)
    w0[0] = 1.0
    return torch.where(total <= 0.0, w0, w)


def apply_emissions(chem: Dict[str, torch.Tensor], emis: Dict[str, torch.Tensor],
                    rho0, dz0, dt: float, plume_w=None, rho=None,
                    dz=None) -> Dict[str, torch.Tensor]:
    """Inject emission fluxes (gases [ppmv/s * m], aerosol [ug/m2/s]) over
    the air mass of the layer they enter: surface keys into the lowest
    layer (rho0 * dz0), ``elev_`` keys over the ``plume_w`` injection
    profile of `plume_rise_profile` (rho, dz 3D).  Keys without a chem
    field (``heat_mw`` among them) are skipped."""
    out = dict(chem)
    for name, flux in emis.items():
        elevated = name.startswith("elev_")
        base = name[5:] if elevated else name
        key = base if base.startswith("chem_") else f"chem_{base}"
        if key not in chem:
            continue
        if elevated and plume_w is not None:
            d = plume_w * flux[None] * dt / torch.clamp(rho * dz, min=1e-3)
            out[key] = out[key] + d
        else:
            d = flux * dt / torch.clamp(rho0 * dz0, min=1e-3)
            new = out[key].clone()
            new[0] = out[key][0] + d
            out[key] = new
    return out


def _collection_efficiency(d_m: float) -> float:
    """Raindrop-aerosol collection efficiency E(d), a host float: Brownian
    capture for small particles, inertial impaction for large, with the
    Greenfield gap (minimum ~1e-3 near 0.3 um) between (Slinn 1983, ~1 mm
    drops)."""
    d_um = d_m * 1e6
    e_brown = 0.1 * (0.01 / d_um) ** (4.0 / 3.0)
    e_impact = (d_um / (d_um + 2.5)) ** 3
    return float(min(1.0, e_brown + e_impact + 1e-4))


def wet_scavenging(chem: Dict[str, torch.Tensor], qr, dt: float,
                   gas_names, nbin: int = 4) -> Dict[str, torch.Tensor]:
    """Size-resolved precipitation scavenging.

    Cloud-borne (_cw) fields drain at the Kessler accretion rate 2.2
    qr^0.875 [1/s], the bulk proxy of the cloud-water -> rain conversion.
    Interstitial bins (below-cloud): Lambda_b = (3/2) E(d_bin) P / (rho_w
    D_rain) with rain rate P = rho qr v_t (rho 1.2, v_t 5 m/s) and D_rain
    = 1 mm.  Soluble gases: Henry-law-weighted first-order uptake.  Keys
    match in that order: _cw, then _a, then the soluble gases."""
    soluble = {"hno3": 1.0, "h2so4": 1.0, "nh3": 0.3, "so2": 0.15,
               "h2o2": 0.7, "hcl": 1.0}
    rain_flux = 1.2 * qr * 5.0
    lam_gas = 1.0e-3 * qr * 1.0e3
    d_rain, rho_w = 1.0e-3, 1000.0
    diams = mbins.make_bins(nbin).d_center
    lam_cw = 2.2 * torch.clamp(qr, min=0.0) ** 0.875
    out = dict(chem)
    for name, arr in chem.items():
        short = name.replace("chem_", "")
        if "_cw" in short:
            out[name] = arr * torch.exp(-lam_cw * dt)
        elif "_a" in short:
            b = int(short[-2:]) - 1
            eff = _collection_efficiency(diams[min(b, nbin - 1)])
            lam_b = 1.5 * eff * rain_flux / (rho_w * d_rain)
            out[name] = arr * torch.exp(-lam_b * dt)
        elif short in soluble:
            out[name] = arr * torch.exp(-soluble[short] * lam_gas * dt)
    return out


# Henry constants [M/atm] at 298K and effective dissociation constants
H_SO2, K1_SO2, K2_SO2 = 1.23, 1.3e-2, 6.6e-8
H_H2O2, H_O3 = 7.45e4, 1.13e-2

QC_CLOUD = 1e-6         # [kg/kg] cloud presence threshold for the cw phase


def _cw_keys(chem) -> bool:
    return any(k.startswith("chem_num_cw") for k in chem)


def cw_exchange(chem: Dict[str, torch.Tensor], qc, t_air, p_air, rho_air,
                w_up, nbin: int) -> Dict[str, torch.Tensor]:
    """Interstitial <-> cloud-borne aerosol exchange.

    In cloudy cells (qc > QC_CLOUD) the AR&G per-bin activated fraction
    sets a floor on the cloud-borne share of each bin's (interstitial +
    cloud-borne) total: activation is a ratchet while the cloud persists.
    Where the cloud has evaporated, the whole cloud-borne load resuspends to
    the interstitial phase.  Each (bin, species) total is conserved to
    rounding."""
    if not _cw_keys(chem):
        return chem
    out = dict(chem)
    _, _, fracs = activate_fractions(chem, t_air, p_air, rho_air, w_up, nbin)
    in_cloud = qc > QC_CLOUD
    species = tuple(mbins.AER_SPECIES) + ("num",)
    for b in range(1, nbin + 1):
        frac = fracs[b - 1]
        for s in species:
            ki = f"chem_{s}_a{b:02d}"
            kc = f"chem_{s}_cw{b:02d}"
            tot = chem[ki] + chem[kc]
            cw_new = torch.where(in_cloud, torch.maximum(chem[kc], frac * tot), 0.0)
            out[kc] = cw_new
            out[ki] = tot - cw_new
    return out


def cloud_chemistry(chem: Dict[str, torch.Tensor], qc, t_air, nbin: int,
                    dt: float) -> Dict[str, torch.Tensor]:
    """Bulk aqueous S(IV) -> S(VI) with pH-dependent H2O2 and O3 pathways
    (rate constants per Seinfeld & Pandis ch. 7).

    - cloud-water pH from the strong-acid balance of the aerosol in the
      droplets, [H+] = clip(2[SO4] + [NO3] - [NH4], 1e-7, 1e-3) M: the
      summed cloud-borne composition when the _cw phase is carried, else
      the largest interstitial bin's;
    - S(IV) speciation from Henry + first/second dissociation;
    - H2O2 path k = 7.45e7 [H+]/(1+13[H+]) [HSO3-][H2O2(aq)]; O3 path
      (k1 [HSO3-] + k2 [SO3--])[O3(aq)], which shuts off below pH ~4.5.
    Consumes so2 and h2o2/o3 (an oxidant the package does not carry
    contributes nothing); the sulfate goes to the cloud-borne bins by
    droplet number, or to the largest interstitial bin."""
    out = dict(chem)
    if "chem_so2" not in chem:      # aerosol-only package: no S(IV) gases
        return out
    zeros = torch.zeros_like(qc)
    lwc = torch.clamp(qc * 1.2, min=0.0)          # kg water / m3 air (~rho=1.2)
    in_cloud = qc > 1e-6
    lwc_l = torch.clamp(lwc * 1e-3, min=1e-9)     # m3 water / m3 air

    def _aq_molar(key, mw):
        ug_m3 = chem.get(key, zeros) * 1.2                # ug/m3 air
        return ug_m3 * 1e-6 / mw / (lwc_l * 1e3)          # mol/L water

    has_cw = _cw_keys(chem)
    if has_cw:
        def _aq_sum(spec):
            tot = zeros
            for b in range(1, nbin + 1):
                tot = tot + _aq_molar(f"chem_{spec}_cw{b:02d}", mbins.MW[spec])
            return tot
        so4_aq, no3_aq, nh4_aq = _aq_sum("so4"), _aq_sum("no3"), _aq_sum("nh4")
    else:
        b_act = nbin
        so4_aq = _aq_molar(f"chem_so4_a{b_act:02d}", mbins.MW["so4"])
        no3_aq = _aq_molar(f"chem_no3_a{b_act:02d}", mbins.MW["no3"])
        nh4_aq = _aq_molar(f"chem_nh4_a{b_act:02d}", mbins.MW["nh4"])
    h_plus = torch.clamp(2.0 * so4_aq + no3_aq - nh4_aq, 1e-7, 1e-3)

    # S(IV) speciation (partial pressures in atm: ppmv * 1e-6)
    p_so2 = chem["chem_so2"] * 1e-6
    hso3 = H_SO2 * K1_SO2 / h_plus * p_so2               # [HSO3-] M
    so3 = hso3 * K2_SO2 / h_plus                          # [SO3--] M
    h2o2_aq = H_H2O2 * chem.get("chem_h2o2", zeros) * 1e-6
    o3_aq = H_O3 * chem.get("chem_o3", zeros) * 1e-6

    k_h2o2 = 7.45e7 * h_plus / (1.0 + 13.0 * h_plus)     # M-1 s-1
    r_h2o2 = k_h2o2 * h2o2_aq * hso3                     # M/s in cloud water
    r_o3 = (3.7e5 * hso3 + 1.5e9 * so3) * o3_aq

    # aqueous M/s -> ppmv/s of gas-phase S converted
    to_ppmv = lwc_l * 1e3 / 40.0 * 1e6
    d_h2o2 = torch.where(in_cloud, r_h2o2 * to_ppmv * dt, 0.0)
    d_o3 = torch.where(in_cloud, r_o3 * to_ppmv * dt, 0.0)
    # limit by available reagents
    d_h2o2 = torch.minimum(d_h2o2, torch.minimum(chem["chem_so2"],
                                                 chem.get("chem_h2o2", zeros)))
    d_o3 = torch.minimum(d_o3, torch.minimum(chem["chem_so2"] - d_h2o2,
                                             chem.get("chem_o3", zeros)))
    d_o3 = torch.clamp(d_o3, min=0.0)

    out["chem_so2"] = chem["chem_so2"] - d_h2o2 - d_o3
    if "chem_h2o2" in chem:
        out["chem_h2o2"] = chem["chem_h2o2"] - d_h2o2
    if "chem_o3" in chem:
        out["chem_o3"] = chem["chem_o3"] - d_o3
    dso4 = ppmv_to_ugkg(d_h2o2 + d_o3, mbins.MW["so4"])
    if has_cw:
        # sulfate made in the droplets joins the cloud-borne bins by droplet
        # (cloud-borne) number; evaporation later resuspends it
        nums = [chem[f"chem_num_cw{b:02d}"] for b in range(1, nbin + 1)]
        tot_n = sum(nums)
        safe = torch.clamp(tot_n, min=1e-10)
        for b, n_b in zip(range(1, nbin + 1), nums):
            w_b = torch.where(tot_n > 1e-10, n_b / safe, 1.0 if b == nbin else 0.0)
            key = f"chem_so4_cw{b:02d}"
            out[key] = chem[key] + dso4 * w_b
    else:
        key = f"chem_so4_a{b_act:02d}"
        out[key] = chem[key] + dso4
    return out
