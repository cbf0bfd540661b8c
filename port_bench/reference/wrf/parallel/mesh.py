"""2D process mesh — the RSL_LITE patch decomposition (port of the JAX
package's `parallel/mesh.py`).

The reference lays its devices out as a ("my", "mx") `jax.sharding.Mesh`
and runs the step under `jax.shard_map`.  The port runs one block per
process over `torch.distributed`: rank r of a mesh_y x mesh_x group owns
block (iy, ix) = divmod(r, mesh_x), the (ny/mesh_y, nx/mesh_x) window of
every (y, x)-split field; z and any band or bin axes stay whole on the
rank.  The process group's backend picks the transport:

- ``nccl``: each rank has its own card and tensors go card to card;
- ``gloo``: CPU tensors (the tests), or several ranks that share one card,
  where every message is staged through host memory (NCCL refuses two
  ranks on one device).

A `Mesh` also counts what its exchanges send (`exchanges`, `bytes_sent`)
and, apart from them, the all-gathers of whole fields that a nest makes
(`all_gathers`, `all_gather_bytes`: the global bytes each assembles on
this rank), for the per-step traffic that `chip_smoke.py` prints.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from port_bench.reference.wrf.parallel.launch import local_rank
from port_bench.reference.wrf.utils.device import DeviceLike, resolve_device

AXIS_Y = "my"
AXIS_X = "mx"


class Mesh:
    """This process's place in a mesh_y x mesh_x decomposition."""

    def __init__(self, mesh_y: int, mesh_x: int, rank: int, group, device: torch.device,
                 backend: Optional[str]):
        self.mesh_y, self.mesh_x = mesh_y, mesh_x
        self.rank = rank
        self.iy, self.ix = divmod(rank, mesh_x)
        self.group = group
        self.device = device
        self.backend = backend          # None: one block and no process group
        self.exchanges = 0              # point-to-point messages sent
        self.bytes_sent = 0
        self.all_gathers = 0            # collectives of `sharded.all_gather_fields`
        self.all_gather_bytes = 0       # global bytes they assembled on this rank

    @property
    def size(self) -> int:
        return self.mesh_y * self.mesh_x

    def __repr__(self) -> str:
        return (f"Mesh({self.mesh_y}x{self.mesh_x}, rank {self.rank} at "
                f"({self.iy}, {self.ix}), {self.backend or 'no group'}, {self.device})")

    # -- neighbours ----------------------------------------------------------

    def global_rank(self, r: int) -> int:
        """The default group's rank of group rank `r` (point-to-point
        operations name their peer that way)."""
        if self.group is None or self.group == dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)

    def neighbour(self, axis: str, step: int) -> int:
        """Group rank of the block `step` (+1 or -1) along `axis`, wrapping
        around the mesh (a periodic domain's seam)."""
        if axis == AXIS_X:
            return self.iy * self.mesh_x + (self.ix + step) % self.mesh_x
        return ((self.iy + step) % self.mesh_y) * self.mesh_x + self.ix

    def index(self, axis: str) -> int:
        return self.ix if axis == AXIS_X else self.iy

    def extent(self, axis: str) -> int:
        return self.mesh_x if axis == AXIS_X else self.mesh_y

    # -- the block -----------------------------------------------------------

    def window(self, ny: int, nx: int) -> Tuple[slice, slice]:
        """This rank's (y, x) slices of a global (ny, nx) plane."""
        by, bx = block_shape(ny, nx, self)
        return (slice(self.iy * by, (self.iy + 1) * by),
                slice(self.ix * bx, (self.ix + 1) * bx))

    def cut(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global tensor whose trailing axes are
        (y, x): a contiguous copy."""
        ys, xs = self.window(a.shape[-2], a.shape[-1])
        return a[..., ys, xs].contiguous()

    # -- transport -------------------------------------------------------------

    @property
    def staged(self) -> bool:
        """Whether messages go through host memory (gloo carrying CUDA
        tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where the transport reads it: on the host under staging."""
        return t.cpu() if self.staged else t.contiguous()

    def wire_empty(self, shape, dtype) -> torch.Tensor:
        """A receive buffer: pinned host memory under staging."""
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def home(self, t: torch.Tensor) -> torch.Tensor:
        """A received tensor back on the rank's device."""
        return t.to(self.device, non_blocking=True) if self.staged else t

    def all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        """`op` (a `dist.ReduceOp`) over the mesh, out of place."""
        if self.backend is None:
            return x
        w = self.wire(x).clone()
        dist.all_reduce(w, op=op, group=self.group)
        return self.home(w)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (same shape and dtype on all), in group-rank
        order, where the transport put them (host under staging)."""
        if self.backend is None:
            return [t]
        w = self.wire(t)
        out = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(out, w, group=self.group)
        return out

    def gather(self, t: torch.Tensor, dst: int = 0) -> Optional[List[torch.Tensor]]:
        """Every rank's `t` (same shape and dtype on all) on group rank
        `dst`, in group-rank order; None on the other ranks."""
        if self.backend is None:
            return [t]
        w = self.wire(t)
        out = [torch.empty_like(w) for _ in range(self.size)] if self.rank == dst else None
        dist.gather(w, out, dst=self.global_rank(dst), group=self.group)
        return out

    def barrier(self) -> None:
        if self.backend is not None:
            dist.barrier(group=self.group)


def make_mesh(mesh_y: int, mesh_x: int, group=None, device: DeviceLike = None) -> Mesh:
    """This process's `Mesh` over `group` (the default group when None).

    The group's size must be mesh_y * mesh_x.  A 1 x 1 mesh needs no
    process group.  The device defaults to ``cuda:{LOCAL_RANK}`` under
    NCCL and to ``cuda`` otherwise (raising without a card, as every entry
    point of the port does); pass ``device="cpu"`` for CPU ranks."""
    if mesh_y < 1 or mesh_x < 1:
        raise ValueError(f"mesh ({mesh_y}, {mesh_x}) must be at least 1 x 1")
    n = mesh_y * mesh_x
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a ({mesh_y}, {mesh_x}) mesh needs an initialised process "
                             f"group of {n} ranks (parallel.launch)")
        return Mesh(1, 1, 0, None, resolve_device(device), None)
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if size != n:
        raise ValueError(f"mesh ({mesh_y}, {mesh_x}) needs {n} ranks, the group has {size}")
    backend = str(dist.get_backend(group))
    rank = dist.get_rank(group)
    if device is None and backend == "nccl":
        device = f"cuda:{local_rank()}"
    return Mesh(mesh_y, mesh_x, rank, group, resolve_device(device), backend)


def block_shape(ny: int, nx: int, mesh: Mesh) -> Tuple[int, int]:
    my, mx = mesh.mesh_y, mesh.mesh_x
    if ny % my or nx % mx:
        raise ValueError(f"grid ({ny},{nx}) not divisible by mesh ({my},{mx})")
    return ny // my, nx // mx
