"""Inter-bin remapping after condensational growth/shrinkage — the
moving-center sectional transfer (port of the JAX package's
`chem/mosaic/movesect.py`; canonical: chem/module_mosaic_movesect.F, which
implements Jacobson's moving-center scheme).

Scheme: each section's mean dry-particle volume v_mean = V_dry/N drifts as
condensation adds mass without adding number.  When v_mean leaves the
section's fixed [v_lo, v_hi) volume range, the WHOLE section's mass (every
species, including water) and number transfer to the section whose range
contains v_mean.  Both moments are conserved exactly by construction (the
transfer is a permutation-like scatter, not a split).

The per-bin data-dependent target index becomes a dense one-hot
(nbin_src x nbin_dst) transfer matrix per cell — a small einsum over the bin
axis, fully branchless, instead of the canonical per-bin DO-loop walk."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.chem.mosaic import bins as mbins


def remap(chem: Dict[str, torch.Tensor], nbin: int) -> Dict[str, torch.Tensor]:
    """Moving-center remap of all aerosol species + number across bins."""
    grid = mbins.make_bins(nbin)
    like = chem["chem_num_a01"]
    v_lo = torch.as_tensor(np.pi / 6.0 * grid.d_lo ** 3, dtype=like.dtype,
                           device=like.device)               # (nbin,)
    v_hi = torch.as_tensor(np.pi / 6.0 * grid.d_hi ** 3, dtype=like.dtype,
                           device=like.device)

    # per-bin mean dry volume (m3 per particle); ug/kg -> m3/kg via density
    v_dry = []
    num = []
    for b in range(1, nbin + 1):
        v = None
        for s in mbins.AER_SPECIES:
            vv = chem[f"chem_{s}_a{b:02d}"] * 1e-9 / mbins.DENSITY[s]
            v = vv if v is None else v + vv
        v_dry.append(v)
        num.append(torch.clamp(chem[f"chem_num_a{b:02d}"], min=0.0))
    v_dry = torch.stack(v_dry)                              # (nbin, nz, ny, nx)
    num = torch.stack(num)
    v_mean = v_dry / torch.clamp(num, min=1.0)                # m3/particle

    # target bin: the section whose [v_lo, v_hi) contains v_mean, clamped to
    # the outermost sections; empty bins (tiny number) stay put
    v_mean = torch.clamp(v_mean, v_lo[0].reshape(1, 1, 1, 1) * 1.0001,
                      v_hi[-1].reshape(1, 1, 1, 1) * 0.9999)
    ge = (v_mean[:, None] >= v_lo[None, :].reshape(1, nbin, 1, 1, 1))
    lt = (v_mean[:, None] < v_hi[None, :].reshape(1, nbin, 1, 1, 1))
    onehot = (ge & lt).to(v_dry.dtype)                # (src, dst, ...)
    empty = (num < 1.0)[:, None]
    eye = torch.eye(nbin, dtype=v_dry.dtype, device=v_dry.device).reshape(
        nbin, nbin, 1, 1, 1)
    onehot = torch.where(empty, eye, onehot)

    out = dict(chem)
    for s in list(mbins.AER_SPECIES) + ["water", "num"]:
        stacked = torch.stack([chem[f"chem_{s}_a{b:02d}"]
                             for b in range(1, nbin + 1)])
        moved = torch.einsum("sd...,s...->d...", onehot, stacked)
        for b in range(1, nbin + 1):
            out[f"chem_{s}_a{b:02d}"] = moved[b - 1]
    return out
