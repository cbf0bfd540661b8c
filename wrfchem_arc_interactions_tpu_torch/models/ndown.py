"""ndown: offline one-way nest forcing from saved coarse-run output (port
of the JAX package's `models/ndown.py`; canonical main/ndown_em.F).

Run the coarse domain with history output, then start a fine domain whose
initial state and lateral boundary stream are interpolated from those
files: no concurrent parent run.  The files are history dumps as
`Simulation(output_dir=...)` writes them (netCDF or npz; `io.history`
reads the JAX package's files too), the interpolation is the online nests'
`ParentToChild`, and the boundary stream is the same `LateralBoundary`
segment list the real-data path emits, so that
``Simulation(cfg_child, grid_child, state0, boundary=segs[k])`` runs it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.grid.grid import make_grid
from wrfchem_arc_interactions_tpu_torch.io import history as hio
from wrfchem_arc_interactions_tpu_torch.models.lateral_bc import (
    LateralBoundary, constant_boundary,
)
from wrfchem_arc_interactions_tpu_torch.models.nest import (
    NestSpec, ParentToChild, child_config,
)
from wrfchem_arc_interactions_tpu_torch.registry.state import build_state
from wrfchem_arc_interactions_tpu_torch.utils.device import DeviceLike, resolve_device

FORCED_DEFAULT = ("u", "v", "w", "t", "mu", "ph", "qv")


def ndown(parent_cfg: Config, history_paths: Sequence[str], spec: NestSpec,
          theta_of_z, forced_names: Tuple[str, ...] = FORCED_DEFAULT,
          device: DeviceLike = None, dtype: torch.dtype = torch.float32):
    """(cfg_child, grid_child, state0, boundary segments) on `device`
    (default ``cuda``; raises if there is none and the CPU was not asked
    for) from a list of coarse-run history files.

    The child starts at the earliest file's time, which becomes its time 0;
    each consecutive pair of files becomes one segment (set
    ``sim.boundary`` to the next as model time crosses its end)."""
    if len(history_paths) < 1:
        raise ValueError("ndown needs at least one parent history file")
    dev = resolve_device(device)
    cfg_child = child_config(parent_cfg, spec)
    interp = ParentToChild(spec, parent_cfg.domain.ny, parent_cfg.domain.nx)
    grid_child = make_grid(cfg_child, theta_of_z, dev, dtype=dtype)

    snaps: List[Tuple[float, dict]] = []
    for path in history_paths:
        fields, t_s = hio.read_history(path)
        target = {}
        for name in forced_names:
            if name not in fields:
                continue
            # the parent's field interpolated in the file's float32
            arr = torch.from_numpy(np.ascontiguousarray(fields[name]))
            target[name] = interp.field(arr, name).to(dtype=dtype, device=dev)
        missing = [n for n in forced_names if n not in target]
        if missing:
            raise ValueError(f"{path}: history lacks forced fields {missing}; write "
                             "history with the default registry history set")
        snaps.append((t_s, target))
    snaps.sort(key=lambda x: x[0])

    state0 = build_state(cfg_child, dev, dtype)
    state0.update(snaps[0][1])

    # the child's clock starts at 0 = the first snapshot's valid time
    t0 = snaps[0][0]
    segs = [LateralBoundary(lo=a, hi=b, t_lo=float(np.float32(ta - t0)),
                            t_hi=float(np.float32(tb - t0)))
            for (ta, a), (tb, b) in zip(snaps[:-1], snaps[1:])]
    return cfg_child, grid_child, state0, segs or [constant_boundary(snaps[0][1])]
