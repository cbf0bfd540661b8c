"""Aerosol optical properties: MOSAIC bins -> (tau, ssa, g) per radiation
band (port of the JAX package's `chem/optics.py`; canonical:
chem/module_optical_driver.F + module_optical_averaging.F
optical_averaging/mieaer).

Per (cell, bin, band): volume-average the complex refractive index over the
species mix including water (volume mixing, aer_op_opt=1), take the wet
size parameter, and evaluate the Chebyshev-fit Mie efficiencies with
bilinear (n_r, log n_i) interpolation.  The SW and LW bands form one
30-band axis; the bins are a Python loop, and each bin's (band, cell)
evaluation is one launch of the Mie kernel (`ops.mie_kernel.cheb_eval`),
whose plain version is `_cheb_eval_bands` below.

Writes the tau_aer_sw / ssa_aer_sw / asy_aer_sw / tau_aer_lw arrays read by
the radiation driver at the next radt alarm (the ARC direct-effect bridge).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.chem import mie
from wrfchem_arc_interactions_tpu_torch.chem.mosaic import bins as mbins
from wrfchem_arc_interactions_tpu_torch.ops.mie_kernel import cheb_eval
from wrfchem_arc_interactions_tpu_torch.physics.radiation import bands as rbands

UG_TO_KG = 1.0e-9


def _hat_weights(nr_n, u):
    """The 80 bilinear hat weights over the (8, 10) refractive-index grid:
    w_{a,b} = tri(nr_n*7 - a) * tri(u*9 - b) with tri(s) = max(0, 1-|s|).
    Rows sum to 1 for inputs in [0, 1]; exact node interpolation."""
    n_nr = len(mie.NR_GRID)
    n_ni = len(mie.NI_GRID)
    fr = nr_n * (n_nr - 1)
    fi = u * (n_ni - 1)
    wa = [torch.clamp(1.0 - torch.abs(fr - a), min=0.0) for a in range(n_nr)]
    wb = [torch.clamp(1.0 - torch.abs(fi - b), min=0.0) for b in range(n_ni)]
    return [a * b for a in wa for b in wb]


def _cheb_eval_bands(G, nr_n, u, t):
    """Plain version of the Mie kernel: a loop over the band axis whose body
    builds the 80 hat weights, contracts all 3*NCHEB Chebyshev coefficients
    as one (90, 80) x (80, ncell) matrix product (exact bilinear
    interpolation of the grid tables) and runs Clenshaw.  One band's
    (80, ncell) weights are live at a time.

    G: (90, 80) grid matrix (numpy or tensor); nr_n, u, t: (nband, *shp).
    Returns (ln_qext, ln_qsca, g), each (nband, *shp)."""
    nch = mie.NCHEB
    C = torch.as_tensor(G, dtype=t.dtype).to(t.device)
    shp = t.shape[1:]
    outs = ([], [], [])
    for b in range(t.shape[0]):
        nr_b, u_b, t_b = (x[b].reshape(-1) for x in (nr_n, u, t))
        W = torch.stack(_hat_weights(nr_b, u_b))             # (80, N)
        cks = C @ W                                          # (3*nch, N)
        t2 = 2.0 * t_b
        for i in range(3):
            ck = cks[i * nch:(i + 1) * nch]
            b0 = b1 = torch.zeros_like(t_b)
            for k in range(nch - 1, -1, -1):
                b0, b1 = t2 * b0 - b1 + ck[k], b0
            outs[i].append((b0 - t_b * b1 - 0.5 * ck[0]).reshape(shp))
    return tuple(torch.stack(o) for o in outs)


def bin_optics(d_wet, n_air, nr_eff, ni_eff, wavelengths_um, tabs: mie.MieTables):
    """Mie optics for one bin over a band axis.

    d_wet: (...,) wet diameter [m]; n_air: (...,) number per m3;
    nr_eff/ni_eff: (nband, ...); wavelengths_um: (nband,).
    Returns (ext, sca, g_as): ext/sca in [1/m].
    """
    dtype = d_wet.dtype
    lam = torch.as_tensor(np.asarray(wavelengths_um) * 1e-6, dtype=dtype).to(
        d_wet.device).reshape((-1,) + (1,) * d_wet.dim())
    x = math.pi * d_wet[None] / lam
    lnx = torch.log(torch.clamp(x, min=1e-6))
    t = torch.clamp(2.0 * (lnx - float(tabs.lnx_min)) / float(tabs.lnx_max - tabs.lnx_min)
                    - 1.0, -1.0, 1.0)
    nrg = mie.NR_GRID
    nr_n = ((torch.clamp(nr_eff, float(nrg[0]), float(nrg[-1])) - float(nrg[0]))
            / float(nrg[-1] - nrg[0]))
    u = (torch.log10(torch.clamp(ni_eff, 1e-9, 1.0)) + 9.0) / 9.0
    t = t.expand(nr_n.shape).contiguous()
    ln_qe, ln_qs, gg = cheb_eval(nr_n.contiguous(), u.contiguous(), t)
    qe = torch.exp(torch.clamp(ln_qe, -60.0, 3.0))
    qs = torch.exp(torch.clamp(ln_qs, -60.0, 3.0))
    qs = torch.minimum(qs, qe)
    gg = torch.clamp(gg, 0.0, 1.0)
    area = 0.25 * math.pi * d_wet ** 2 * n_air
    return qe * area[None], qs * area[None], gg


def aerosol_optics(chem_fields: Dict[str, torch.Tensor], rho_air, dz,
                   nbin: int) -> Dict[str, torch.Tensor]:
    """(tau, ssa, asy) per SW band + absorption tau per LW band.

    chem_fields: state chem arrays (ug/kg masses, #/kg numbers), each
    (nz, ny, nx); rho_air, dz the same shape.
    """
    dtype = rho_air.dtype
    tabs = mie.build_cheb_tables()
    all_um = np.concatenate([rbands.band_centers_sw_um(), rbands.band_centers_lw_um()])
    nb_sw = rbands.NBND_SW
    sp = mbins.species_arrays(all_um)
    names = list(mbins.AER_SPECIES) + ["water"]
    nr_sp = torch.as_tensor(sp["nr"], dtype=dtype).to(rho_air.device)   # (nsp, nband)
    ni_sp = torch.as_tensor(sp["ni"], dtype=dtype).to(rho_air.device)

    ext_t = sca_t = gsca_t = None
    for b in range(1, nbin + 1):
        v_sp = torch.stack([chem_fields[f"chem_{s}_a{b:02d}"]
                            * (UG_TO_KG / mbins.DENSITY[s]) for s in names])
        num = torch.clamp(chem_fields[f"chem_num_a{b:02d}"], min=1.0)
        vol = torch.clamp(torch.sum(v_sp, dim=0), min=1e-30)
        frac = v_sp / vol                                    # (nsp, *shp)
        d_wet = torch.clamp((6.0 * vol / (math.pi * num)) ** (1.0 / 3.0),
                            1e-9, 50e-6)
        n_air = num * rho_air
        # volume-mixed refractive index per band: (nband, *shp)
        nr_eff = torch.einsum("sb,s...->b...", nr_sp, frac)
        ni_eff = torch.einsum("sb,s...->b...", ni_sp, frac)
        ext, sca, gg = bin_optics(d_wet, n_air, nr_eff, ni_eff, all_um, tabs)
        ext_dz, sca_dz, gsca_dz = ext * dz[None], sca * dz[None], gg * sca * dz[None]
        if ext_t is None:
            # the reference's carry starts at zero: 0 + x is x exactly
            ext_t, sca_t, gsca_t = ext_dz, sca_dz, gsca_dz
        else:
            ext_t, sca_t, gsca_t = ext_t + ext_dz, sca_t + sca_dz, gsca_t + gsca_dz

    tau_sw = ext_t[:nb_sw]
    sca_sw = sca_t[:nb_sw]
    gsca_sw = gsca_t[:nb_sw]
    tau_lw_abs = ext_t[nb_sw:] - sca_t[nb_sw:]
    ssa = torch.where(tau_sw > 0, sca_sw / torch.clamp(tau_sw, min=1e-30), 1.0)
    asy = torch.where(sca_sw > 0, gsca_sw / torch.clamp(sca_sw, min=1e-30), 0.0)
    return {"tau_aer_sw": tau_sw, "ssa_aer_sw": torch.clamp(ssa, 0.0, 1.0),
            "asy_aer_sw": torch.clamp(asy, 0.0, 1.0),
            "tau_aer_lw": torch.clamp(tau_lw_abs, min=0.0)}
