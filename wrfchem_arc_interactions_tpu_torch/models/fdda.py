"""FDDA analysis (grid) nudging (port of the JAX package's `models/fdda.py`;
canonical phys/module_fdda_psufddagd.F, called from
dyn_em/module_first_rk_step_part2.F).

Newtonian relaxation of the prognostic fields toward a time-interpolated
gridded analysis,

    d(f)/dt += G_f * (f_analysis(t) - f)

for f in {u, v, theta', qv} with the coefficients guv/gt/gq [1/s].  The
analysis is a two-snapshot `LateralBoundary` (its ``at_time`` does the
linear time interpolation).  The tendencies join the held physics
tendencies before the RK loop, the fdda slot of first_rk_step_part2.
``k_start`` masks nudging below a model level (the if_no_pbl_nudging
analog: analysis increments should not fight the resolved boundary layer).
"""

from __future__ import annotations

from typing import Dict

import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.registry.state import State

# state field -> (tendency key read by dycore/solve.py, coefficient)
_NUDGED = (("u", "u", "guv"), ("v", "v", "guv"),
           ("t", "th", "gt"), ("qv", "qv", "gq"))


def grid_nudge_tendencies(state: State, analysis: Dict[str, torch.Tensor],
                          cfg: Config) -> Dict[str, torch.Tensor]:
    """Nudging tendencies toward `analysis` (full-domain targets in the
    prognostic conventions: u/v [m/s], t = theta perturbation, qv)."""
    fd = cfg.fdda
    tend: Dict[str, torch.Tensor] = {}
    for field, key, coef_name in _NUDGED:
        if field not in analysis or field not in state:
            continue
        g = getattr(fd, coef_name)
        d = g * (analysis[field] - state[field])
        if fd.k_start > 0:
            nz = d.shape[0]
            mask = (torch.arange(nz, device=d.device) >= fd.k_start).to(d.dtype)
            d = d * mask.reshape((nz,) + (1,) * (d.dim() - 1))
        tend[key] = d
    return tend


def apply_nudging(phys_tend: Dict[str, torch.Tensor], state: State,
                  analysis_container, time_s, cfg: Config) -> Dict[str, torch.Tensor]:
    """The held physics tendencies with the nudging added (the
    first_rk_step_part2 call order)."""
    nudge = grid_nudge_tendencies(state, analysis_container.at_time(time_s), cfg)
    out = dict(phys_tend)
    for k, v in nudge.items():
        out[k] = out[k] + v if k in out else v
    return out
