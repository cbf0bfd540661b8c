"""State construction from the field table (port of the JAX package's
`registry/state.py`): the state is a plain ``dict[str, torch.Tensor]``.

`partition_spec` says which axes of a field split over a process mesh
(`parallel.mesh`): y over the mesh's "my" axis, x over "mx", z and any
band, bin or soil axis whole on every rank.  Horizontal staggering does not
change array sizes, so every split is even."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from port_bench.reference.wrf.config import Config
from port_bench.reference.wrf.registry.fields import FieldSpec, field_table
from port_bench.reference.wrf.utils.device import DeviceLike

State = Dict[str, torch.Tensor]


def build_state(cfg: Config, device: DeviceLike,
                dtype: torch.dtype = torch.float32) -> State:
    """Allocate an all-zeros state for this configuration."""
    d = cfg.domain
    return {spec.name: torch.zeros(spec.shape(d.nz, d.ny, d.nx), dtype=dtype,
                                   device=device)
            for spec in field_table(cfg)}


def spec_index(cfg: Config) -> Dict[str, FieldSpec]:
    return {s.name: s for s in field_table(cfg)}


PartitionSpec = Tuple[Optional[str], ...]


def partition_spec(spec: FieldSpec, mesh_axes: Tuple[str, str] = ("my", "mx")) -> PartitionSpec:
    """One entry per axis of the field: the mesh axis it splits over, or
    None where it stays whole (the vertical is never decomposed)."""
    parts = [None for _ in spec.extra]
    for d in spec.dims:
        parts.append(mesh_axes[0] if d == "y" else mesh_axes[1] if d == "x" else None)
    return tuple(parts)


def state_partition_specs(cfg: Config,
                          mesh_axes: Tuple[str, str] = ("my", "mx")) -> Dict[str, PartitionSpec]:
    return {s.name: partition_spec(s, mesh_axes) for s in field_table(cfg)}


def restart_names(cfg: Config) -> Tuple[str, ...]:
    """Fields of the exact-restart set (the Registry `r` flag)."""
    return tuple(s.name for s in field_table(cfg) if s.restart)


def history_names(cfg: Config) -> Tuple[str, ...]:
    """Fields of the history stream (the Registry `h` flag)."""
    return tuple(s.name for s in field_table(cfg) if s.history)


def advected_names(cfg: Config) -> Tuple[str, ...]:
    """Scalar-advection set, in table order."""
    return tuple(s.name for s in field_table(cfg) if s.advected)


def halo_width(cfg: Config) -> int:
    return max((s.halo for s in field_table(cfg)), default=0)


def validate_state(cfg: Config, state: State) -> None:
    """Shape-check a state dict against the registry (debug aid)."""
    d = cfg.domain
    table = spec_index(cfg)
    missing = set(table) - set(state)
    extra = set(state) - set(table)
    if missing or extra:
        raise ValueError(f"state/table mismatch: missing={sorted(missing)} extra={sorted(extra)}")
    for name, spec in table.items():
        want = spec.shape(d.nz, d.ny, d.nx)
        got = tuple(state[name].shape)
        if want != got:
            raise ValueError(f"{name}: shape {got}, registry expects {want}")


def state_from_numpy(arrays: Mapping[str, np.ndarray], device: DeviceLike) -> State:
    """Carry a state given as numpy arrays (for example the JAX package's
    state through ``np.asarray``) onto `device`, keeping each dtype.  An
    emissions dict ({species or ``elev_`` species: (ny, nx) flux,
    ``heat_mw``}) carries over the same way."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in arrays.items()}
