"""Brownian coagulation between sectional bins (port of the JAX package's
`chem/mosaic/coag.py`; canonical: chem/module_mosaic_coag.F).

Fuchs-corrected Brownian kernel on the (nbin x nbin) pair table; the
destination bin of each collision pair is precomputed on the host (static
table), so the update is a short unrolled loop of elementwise work —
branchless and fixed-cost like the rest of the chem stack.
Semi-implicit number loss keeps the scheme stable at large chemdt.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from port_bench.reference.wrf.chem.mosaic import bins as mbins

KB = 1.380649e-23
T_REF = 288.0
MU_AIR = 1.8e-5       # dynamic viscosity [Pa s]
LAMBDA_AIR = 6.5e-8


def brownian_kernel(d1: float, d2: float) -> float:
    """Fuchs transition-regime Brownian coagulation kernel [m3/s] (host)."""
    def diff(d):
        kn = 2.0 * LAMBDA_AIR / d
        cc = 1.0 + kn * (1.257 + 0.4 * np.exp(-1.1 / kn))
        return KB * T_REF * cc / (3.0 * np.pi * MU_AIR * d)
    d_sum = d1 + d2
    b1, b2 = diff(d1), diff(d2)
    k_cont = 2.0 * np.pi * (b1 + b2) * d_sum
    # Fuchs correction (approximate transition form)
    def vel(d, rho=1500.0):
        m = rho * np.pi / 6.0 * d ** 3
        return np.sqrt(8.0 * KB * T_REF / (np.pi * m))
    g_mean = np.sqrt(vel(d1) ** 2 + vel(d2) ** 2)
    k_free = np.pi / 4.0 * d_sum ** 2 * g_mean
    return k_cont * k_free / (k_cont + k_free)


def _pair_tables(grid: mbins.BinGrid):
    n = grid.nbin
    kern = np.zeros((n, n))
    target = np.zeros((n, n), dtype=int)
    for i in range(n):
        for j in range(n):
            kern[i, j] = brownian_kernel(grid.d_center[i], grid.d_center[j])
            v_new = grid.v_center[i] + grid.v_center[j]
            t = np.searchsorted(grid.v_center, v_new) - 0
            target[i, j] = min(max(t, max(i, j)), n - 1)
    return kern, target


def coagulate(chem: Dict[str, torch.Tensor], rho_air, nbin: int,
              dt: float) -> Dict[str, torch.Tensor]:
    grid = mbins.make_bins(nbin)
    kern, target = _pair_tables(grid)
    species = list(mbins.AER_SPECIES) + ["water"]
    num = [chem[f"chem_num_a{b:02d}"] * rho_air for b in range(1, nbin + 1)]  # #/m3
    out = dict(chem)

    # semi-implicit number loss per bin: dN_i = -N_i sum_j K_ij N_j dt
    loss_rate = []
    for i in range(nbin):
        lr = sum(kern[i][j] * num[j] for j in range(nbin))
        loss_rate.append(lr)

    # pair fluxes: number of collisions per m3 over dt (explicit, small)
    for i in range(nbin):
        for j in range(i, nbin):
            tgt = int(target[i, j])
            sym = 0.5 if i == j else 1.0
            n_coll = sym * kern[i][j] * num[i] * num[j] * dt
            n_coll = torch.clamp(n_coll, max=0.5 * torch.clamp(num[i], max=num[j]))
            # number: two particles -> one in target bin
            key_i = f"chem_num_a{i + 1:02d}"
            key_j = f"chem_num_a{j + 1:02d}"
            key_t = f"chem_num_a{tgt + 1:02d}"
            dn = n_coll / rho_air                   # back to #/kg
            out[key_i] = out[key_i] - dn
            out[key_j] = out[key_j] - dn
            out[key_t] = out[key_t] + dn
            # mass: move proportional share of each source bin's mass
            for b_src, key_n in ((i, key_i), (j, key_j)):
                if b_src == tgt:
                    continue
                frac_moved = dn / torch.clamp(chem[f"chem_num_a{b_src + 1:02d}"], min=1.0)
                frac_moved = torch.clamp(frac_moved, 0.0, 0.5)
                for s in species:
                    k_src = f"chem_{s}_a{b_src + 1:02d}"
                    k_tgt = f"chem_{s}_a{tgt + 1:02d}"
                    moved = chem[k_src] * frac_moved
                    out[k_src] = out[k_src] - moved
                    out[k_tgt] = out[k_tgt] + moved
    for b in range(1, nbin + 1):
        out[f"chem_num_a{b:02d}"] = torch.clamp(out[f"chem_num_a{b:02d}"], min=0.0)
    return out
