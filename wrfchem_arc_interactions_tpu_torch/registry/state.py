"""State construction from the field table (port of the JAX package's
`registry/state.py`): the state is a plain ``dict[str, torch.Tensor]``."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.registry.fields import field_table
from wrfchem_arc_interactions_tpu_torch.utils.device import DeviceLike

State = Dict[str, torch.Tensor]


def build_state(cfg: Config, device: DeviceLike,
                dtype: torch.dtype = torch.float32) -> State:
    """Allocate an all-zeros state for this configuration."""
    d = cfg.domain
    return {spec.name: torch.zeros(spec.shape(d.nz, d.ny, d.nx), dtype=dtype,
                                   device=device)
            for spec in field_table(cfg)}


def advected_names(cfg: Config) -> Tuple[str, ...]:
    """Scalar-advection set, in table order."""
    return tuple(s.name for s in field_table(cfg) if s.advected)


def state_from_numpy(arrays: Mapping[str, np.ndarray], device: DeviceLike) -> State:
    """Carry a state given as numpy arrays (for example the JAX package's
    state through ``np.asarray``) onto `device`, keeping each dtype."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in arrays.items()}
