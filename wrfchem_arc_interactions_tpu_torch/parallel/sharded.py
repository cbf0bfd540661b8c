"""Running the model over a process mesh (port of the JAX package's
`parallel/sharded.py`).

The reference wraps the step in `jax.shard_map` with registry-derived
PartitionSpecs.  Here every rank runs the unchanged step on its own block:
`place` cuts the rank's block out of the global state and grid (the same
global tensors on every rank), by the field table's partition specs
(`registry.state.state_partition_specs`) and the grid's, and moves it to
the rank's device, and the
step's halos come through the mesh-aware `HaloOps` that `halo_ops_for`
builds.  `gather` brings the blocks back into global tensors on one rank
(the output streams write from there); `all_gather_fields` brings them to
every rank, where a nest applies its global operators (the reference runs
them as auto-sharded ops outside its `shard_map` regions).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.grid.grid import TENSOR_FIELDS, Grid
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
from wrfchem_arc_interactions_tpu_torch.parallel.mesh import AXIS_X, AXIS_Y, Mesh, block_shape
from wrfchem_arc_interactions_tpu_torch.registry.state import (
    PartitionSpec, State, state_partition_specs,
)


def grid_partition_specs(grid: Grid) -> Dict[str, PartitionSpec]:
    """The Grid's tensors: trailing (ny, nx) axes split over the mesh, the
    1D vertical-coordinate arrays whole on every rank."""
    specs = {}
    for name in TENSOR_FIELDS:
        nd = getattr(grid, name).dim()
        if nd == 1:
            specs[name] = (None,)
        elif nd in (2, 3):
            specs[name] = (None,) * (nd - 2) + (AXIS_Y, AXIS_X)
        else:
            raise ValueError(f"grid field {name} has {nd} axes")
    return specs


def halo_ops_for(cfg: Config, mesh: Optional[Mesh]) -> HaloOps:
    return HaloOps(bc_x=cfg.dynamics.bc_x, bc_y=cfg.dynamics.bc_y, mesh=mesh,
                   fuse=cfg.parallel.halo_fuse)


def _cut(name: str, a: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global tensor `a` by its partition spec:
    whole where no axis splits, else split over its trailing (y, x)."""
    if len(spec) != a.dim():
        raise ValueError(f"{name}: {a.dim()} axes, but its partition spec {spec} has "
                         f"{len(spec)}")
    if AXIS_Y not in spec and AXIS_X not in spec:
        return a
    if spec[-2:] != (AXIS_Y, AXIS_X) or AXIS_Y in spec[:-2] or AXIS_X in spec[:-2]:
        raise ValueError(f"{name}: partition spec {spec} does not split the trailing "
                         f"(y, x) axes")
    return mesh.cut(a)


def place_fields(fields: Mapping[str, torch.Tensor], mesh: Mesh, ny: int,
                 nx: int) -> Dict[str, torch.Tensor]:
    """This rank's blocks of global fields outside the field table
    (emission fluxes, boundary snapshots, nudging targets) on its device:
    every tensor whose trailing axes are the global (ny, nx) is cut, any
    other is kept whole."""
    return {k: (mesh.cut(v) if v.dim() >= 2 and tuple(v.shape[-2:]) == (ny, nx)
                else v).to(mesh.device)
            for k, v in fields.items()}


def place_state(state: State, mesh: Mesh, cfg: Config) -> State:
    """This rank's block of the global `state` on its device: each field
    cut by its entry of the field table's partition specs for `cfg` (a
    field the table does not hold raises)."""
    specs = state_partition_specs(cfg, (AXIS_Y, AXIS_X))
    unknown = sorted(set(state) - set(specs))
    if unknown:
        raise KeyError(f"state fields not in the field table: {unknown}")
    return {k: _cut(k, v, specs[k], mesh).to(mesh.device) for k, v in state.items()}


def place(state: State, grid: Grid, mesh: Mesh, cfg: Config) -> Tuple[State, Grid]:
    """This rank's block of the global `state` (`place_state`) and `grid`,
    on its device."""
    block_shape(grid.ny, grid.nx, mesh)          # raises unless the split is even
    g = dataclasses.replace(grid, **{k: _cut(k, getattr(grid, k), sp, mesh).to(mesh.device)
                                     for k, sp in grid_partition_specs(grid).items()})
    return place_state(state, mesh, cfg), g


def _by_dtype(tensors: Mapping[str, torch.Tensor]) -> Dict[torch.dtype, list]:
    """The names of `tensors` grouped by dtype, in order: one flat message
    per group."""
    groups: Dict[torch.dtype, list] = {}
    for k, v in tensors.items():
        groups.setdefault(v.dtype, []).append(k)
    return groups


def _assemble(parts, names, tensors: Mapping[str, torch.Tensor],
              mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Global tensors from every rank's flat message (`parts`, in group-rank
    order, each the blocks of `names` concatenated), where the parts lie."""
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k in names:
        shape = tensors[k].shape
        by, bx = shape[-2], shape[-1]
        g = torch.empty(shape[:-2] + (by * mesh.mesh_y, bx * mesh.mesh_x),
                        dtype=tensors[k].dtype, device=parts[0].device)
        n = tensors[k].numel()
        for r, p in enumerate(parts):
            iy, ix = divmod(r, mesh.mesh_x)
            g[..., iy * by:(iy + 1) * by, ix * bx:(ix + 1) * bx] = p[off:off + n].view(shape)
        out[k] = g
        off += n
    return out


def gather(tensors: Mapping[str, torch.Tensor], mesh: Optional[Mesh],
           dst: int = 0) -> Optional[Dict[str, torch.Tensor]]:
    """The global tensors, on the host of group rank `dst`, from every
    rank's blocks (each tensor's trailing axes (y, x) split over the mesh);
    None on the other ranks.  Every rank of the mesh must call it, with the
    same names in the same order.  Without a mesh, host copies."""
    if mesh is None or mesh.size == 1:
        return {k: v.detach().cpu() for k, v in tensors.items()}
    out: Dict[str, torch.Tensor] = {}
    for names in _by_dtype(tensors).values():
        flat = torch.cat([tensors[k].detach().reshape(-1) for k in names])
        parts = mesh.gather(flat, dst)
        if parts is not None:
            out.update(_assemble([p.cpu() for p in parts], names, tensors, mesh))
    return out if mesh.rank == dst else None


def all_gather_fields(tensors: Mapping[str, torch.Tensor],
                      mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The global tensors on every rank's device, from every rank's blocks
    (each tensor's trailing axes (y, x) split over the mesh): one
    all-gather per dtype, counted in the mesh's `all_gathers` and
    `all_gather_bytes`.  Every rank of the mesh must call it, with the
    same names in the same order.  Without a mesh, or on a 1 x 1 mesh, the
    tensors themselves."""
    if mesh is None or mesh.size == 1:
        return dict(tensors)
    out: Dict[str, torch.Tensor] = {}
    for names in _by_dtype(tensors).values():
        flat = torch.cat([tensors[k].detach().reshape(-1) for k in names])
        parts = mesh.all_gather(flat)
        mesh.all_gathers += 1
        mesh.all_gather_bytes += mesh.size * flat.numel() * flat.element_size()
        out.update({k: v.to(mesh.device)
                    for k, v in _assemble(parts, names, tensors, mesh).items()})
    return {k: out[k] for k in tensors}


def make_sharded_step(cfg: Config, grid: Grid, mesh: Mesh, step_fn: Callable, dt: float):
    """(step, place) for ``step_fn(state, grid, cfg, hx, dt) -> state`` on
    this rank's block: ``step(s, g)`` advances the block with the mesh's
    halos, ``place(state, grid)`` cuts the block out of the global inputs,
    as the reference's `make_sharded_step` returns."""
    hx = halo_ops_for(cfg, mesh)

    def step(s: State, g: Grid) -> State:
        return step_fn(s, g, cfg, hx, dt)

    def place_inputs(state: State, grid_in: Grid) -> Tuple[State, Grid]:
        return place(state, grid_in, mesh, cfg)

    return step, place_inputs
