"""Halo exchange — RSL_LITE's halo pads (port of the JAX package's
`parallel/halo.py`).

One interface, two execution paths:

- **One block** (no mesh, or a 1 x 1 one): the halos are physical
  boundary conditions.  Periodic wraps (``circular``), open replicates the
  edge (``replicate``), symmetric reflects without repeating the edge
  (``reflect``, as ``jnp.pad``'s ``reflect`` does).  A specified boundary
  replicates the edge like an open one: its outermost rows are set to the
  boundary data after each step (`models.lateral_bc`), so the halo beyond
  them only needs a consistent extrapolation.
- **A block of a mesh** (`parallel.mesh.Mesh`, one block per process):
  on a decomposed axis the halos come from the neighbouring blocks by
  point-to-point messages (`torch.distributed`), and a mesh-edge block
  fills its outer halo from the physical boundary as above.  An axis that
  the mesh does not split is padded locally.  The X phase runs first, on
  the unpadded block, then the Y phase on the X-padded one, so that the
  corners come from the diagonal neighbours, as RSL_LITE's EXCH_X/EXCH_Y
  and the reference's two ppermutes do.  Each mode is a copy, so a block's
  pad equals the window of the single-device pad bit for bit.

`pad_many` packs same-shaped, same-dtype fields into one stacked exchange
(RSL_LITE's packed message buffers) when `fuse` is on
(``cfg.parallel.halo_fuse``).  `psum` and `pmax` are `all_reduce`s over the
mesh.  `overlap_stencil` runs a plus-shaped stencil's bulk over locally
padded blocks while the strips are in flight (NCCL's own stream, or
gloo's thread), then recomputes the four edge bands from the true halos.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from port_bench.reference.wrf.config.namelist import BCKind
from port_bench.reference.wrf.parallel.mesh import AXIS_X, AXIS_Y, Mesh

_MODES = {BCKind.PERIODIC: "circular", BCKind.OPEN: "replicate",
          BCKind.SYMMETRIC: "reflect", BCKind.SPECIFIED: "replicate"}

# message tags by axis: strips travelling toward +axis (a high strip
# becomes the neighbour's low halo) and toward -axis
_TAGS = {AXIS_X: (0, 1), AXIS_Y: (2, 3)}


def _local_pad(a: torch.Tensor, axis: int, width: int, bc: BCKind) -> torch.Tensor:
    """Pad trailing axis `axis` (-1 for x, -2 for y) by the boundary rule."""
    shape = a.shape
    a4 = a.reshape(-1, 1, shape[-2], shape[-1])
    pw = (width, width, 0, 0) if axis == -1 else (0, 0, width, width)
    a4 = F.pad(a4, pw, mode=_MODES[bc])
    return a4.reshape(shape[:-2] + a4.shape[-2:])


def _bc_strip(a: torch.Tensor, axis: int, width: int, bc: BCKind, side: str) -> torch.Tensor:
    """The physical boundary's halo strip on `side` ('lo' or 'hi') of
    trailing axis `axis`: what `_local_pad` puts there."""
    n = a.shape[axis]
    if bc in (BCKind.OPEN, BCKind.SPECIFIED):
        edge = a.narrow(axis, 0 if side == "lo" else n - 1, 1)
        reps = [1] * a.dim()
        reps[axis] = width
        return edge.repeat(reps)
    if bc == BCKind.SYMMETRIC:
        if n <= width:
            raise ValueError(f"a symmetric boundary reflects {width} cells; the block "
                             f"has {n}")
        strip = a.narrow(axis, 1 if side == "lo" else n - 1 - width, width)
        return strip.flip(axis)
    raise ValueError(bc)     # periodic seams are exchanged, never filled


@dataclasses.dataclass(frozen=True)
class HaloOps:
    """Boundary/halo context threaded through the dycore.

    `mesh` is this process's block of a decomposition (None: one block);
    `fuse` packs same-shaped fields into one exchange in `pad_many`."""

    bc_x: BCKind = BCKind.PERIODIC
    bc_y: BCKind = BCKind.PERIODIC
    mesh: Optional[Mesh] = None
    fuse: bool = True

    @property
    def mesh_y(self) -> int:
        return 1 if self.mesh is None else self.mesh.mesh_y

    @property
    def mesh_x(self) -> int:
        return 1 if self.mesh is None else self.mesh.mesh_x

    @property
    def sharded(self) -> bool:
        """Whether some axis is split over several blocks."""
        return self.mesh_y > 1 or self.mesh_x > 1

    def _axes(self):
        """(trailing axis, boundary, mesh axis name), X first."""
        return ((-1, self.bc_x, AXIS_X), (-2, self.bc_y, AXIS_Y))

    def _split(self, name: str) -> bool:
        return self.mesh is not None and self.mesh.extent(name) > 1

    def edge_sides(self) -> Tuple[Tuple[str, Optional[BCKind]], ...]:
        """What lies beyond each side of the block, in the order west,
        east, south, north: ("seam", None) where a neighbouring block does
        (a periodic axis split over several blocks has seams on both
        sides), else ("boundary", kind)."""
        out = []
        for _, bc, name in self._axes():
            for lo in (True, False):
                if self._split(name) and (bc == BCKind.PERIODIC or (
                        self.mesh.index(name) > 0 if lo
                        else self.mesh.index(name) < self.mesh.extent(name) - 1)):
                    out.append(("seam", None))
                else:
                    out.append(("boundary", bc))
        return tuple(out)

    # -- exchange ------------------------------------------------------------

    def _post(self, a: torch.Tensor, axis: int, width: int, bc: BCKind, name: str):
        """Start the exchange of `a`'s strips along one split axis; returns
        (works, receive buffers {'lo'|'hi': buffer}, physical strips)."""
        m = self.mesh
        n = a.shape[axis]
        if n < width:
            raise ValueError(
                f"block extent {n} on axis {a.dim() + axis} is smaller than "
                f"the halo width {width}: decompose fewer ways or enlarge the "
                f"domain (RSL_LITE's min-patch-size rule)")
        i, nm = m.index(name), m.extent(name)
        periodic = bc == BCKind.PERIODIC
        has_lo = periodic or i > 0            # a block lies at -1
        has_hi = periodic or i < nm - 1       # ... and at +1
        lo_peer = m.global_rank(m.neighbour(name, -1))
        hi_peer = m.global_rank(m.neighbour(name, +1))
        up, down = _TAGS[name]
        shape = list(a.shape)
        shape[axis] = width
        ops, bufs, fills = [], {}, {}
        if has_hi:
            strip = m.wire(a.narrow(axis, n - width, width))
            ops.append(dist.P2POp(dist.isend, strip, hi_peer, m.group, up))
            m.exchanges += 1
            m.bytes_sent += strip.numel() * strip.element_size()
        if has_lo:
            strip = m.wire(a.narrow(axis, 0, width))
            ops.append(dist.P2POp(dist.isend, strip, lo_peer, m.group, down))
            m.exchanges += 1
            m.bytes_sent += strip.numel() * strip.element_size()
            bufs["lo"] = m.wire_empty(shape, a.dtype)
            ops.append(dist.P2POp(dist.irecv, bufs["lo"], lo_peer, m.group, up))
        else:
            fills["lo"] = _bc_strip(a, axis, width, bc, "lo")
        if has_hi:
            bufs["hi"] = m.wire_empty(shape, a.dtype)
            ops.append(dist.P2POp(dist.irecv, bufs["hi"], hi_peer, m.group, down))
        else:
            fills["hi"] = _bc_strip(a, axis, width, bc, "hi")
        return dist.batch_isend_irecv(ops), bufs, fills

    def _land(self, pending) -> Tuple[torch.Tensor, torch.Tensor]:
        """Wait for one axis's exchange; its (lo, hi) halo strips."""
        works, bufs, fills = pending
        for w in works:
            w.wait()
        got = {k: self.mesh.home(b) for k, b in bufs.items()}
        got.update(fills)
        return got["lo"], got["hi"]

    def _pad_axis(self, a: torch.Tensor, axis: int, width: int, bc: BCKind,
                  name: str) -> torch.Tensor:
        if not self._split(name):
            return _local_pad(a, axis, width, bc)
        lo, hi = self._land(self._post(a, axis, width, bc, name))
        return torch.cat([lo, a, hi], dim=axis)

    # -- public API ----------------------------------------------------------

    def pad(self, a: torch.Tensor, width: int = 3) -> torch.Tensor:
        """Pad the trailing (y, x) axes by `width` halo cells (X then Y
        phase, so that the corners are filled)."""
        if not self.sharded:
            a = _local_pad(a, -1, width, self.bc_x)
            return _local_pad(a, -2, width, self.bc_y)
        for axis, bc, name in self._axes():
            a = self._pad_axis(a, axis, width, bc, name)
        return a

    def _groups(self, fields: Dict[str, torch.Tensor]) -> List[List[str]]:
        """Names that travel in one message: same shape and dtype under
        `fuse` on a mesh, else one name each."""
        if not (self.fuse and self.sharded):
            return [[n] for n in fields]
        groups: Dict[Tuple[Tuple[int, ...], torch.dtype], List[str]] = {}
        for name, a in fields.items():
            groups.setdefault((tuple(a.shape), a.dtype), []).append(name)
        return list(groups.values())

    def pad_many(self, fields: Dict[str, torch.Tensor],
                 width: int = 3) -> Dict[str, torch.Tensor]:
        """Pad every field; under `fuse` on a mesh, same-shaped fields are
        stacked into one exchange."""
        out: Dict[str, torch.Tensor] = {}
        for names in self._groups(fields):
            if len(names) == 1:
                out[names[0]] = self.pad(fields[names[0]], width)
                continue
            padded = self.pad(torch.stack([fields[n] for n in names]), width)
            for i, n in enumerate(names):
                out[n] = padded[i]
        return out

    # -- global reductions (diagnostics, CFL guards) ---------------------------

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sharded:
            return x
        return self.mesh.all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sharded:
            return x
        return self.mesh.all_reduce(x, dist.ReduceOp.MAX)

    # -- overlapped halo exchange --------------------------------------------
    #
    # The split-stencil schedule: both axes' strips leave up front from the
    # *unpadded* block (concurrently, unlike pad()'s X-then-Y phases), the
    # stencil runs over the whole block on a locally edge-replicated pad
    # (wrong near the block's edges, but independent of the messages), then
    # the thin edge bands are recomputed from the true halos.  The two
    # exchanges never see each other, so the CORNER cells of the padded
    # array are not the diagonal neighbour's: callers are plus-shaped
    # stencils (x-terms use x-offsets only, y-terms y-offsets only).

    def exchange_start(self, a: torch.Tensor, width: int):
        """Start the strip exchanges of both axes; per axis (Y, X) the
        pending exchange, or None where the axis is not split."""
        return tuple(self._post(a, axis, width, bc, name) if self._split(name) else None
                     for axis, bc, name in reversed(self._axes()))

    def exchange_finish(self, a: torch.Tensor, pending, width: int) -> torch.Tensor:
        """The padded block from started exchanges.  Corner halo cells are
        edge-replicated, not the diagonal neighbour's (see above): valid
        for plus-shaped stencils only."""
        pend_y, pend_x = pending
        if pend_x is None:
            a = _local_pad(a, -1, width, self.bc_x)
        else:
            lo, hi = self._land(pend_x)
            a = torch.cat([lo, a, hi], dim=-1)
        if pend_y is None:
            return _local_pad(a, -2, width, self.bc_y)
        lo, hi = self._land(pend_y)
        # the true strips span the unpadded x range: extend them over the
        # new x halos by edge replication (the corners)
        lo = _local_pad(lo, -1, width, BCKind.OPEN)
        hi = _local_pad(hi, -1, width, BCKind.OPEN)
        return torch.cat([lo, a, hi], dim=-2)

    @staticmethod
    def local_pad(a: torch.Tensor, width: int) -> torch.Tensor:
        """Edge-replicated local pad: right in the block's interior, wrong
        within `width` of its edges; the bulk pass of `overlap_stencil`."""
        return _local_pad(_local_pad(a, -1, width, BCKind.OPEN), -2, width, BCKind.OPEN)


def overlap_stencil(hx: HaloOps, fields: Dict[str, torch.Tensor], width: int,
                    fn: Callable, consts: Optional[Dict[str, torch.Tensor]] = None,
                    overlap: bool = True):
    """Evaluate a plus-shaped stencil with its halo exchange overlapped by
    compute.

    ``fn(padded_fields, consts) -> {name: tensor}`` takes fields padded by
    `width` and interior-sized consts and returns interior-sized outputs
    whose trailing axes are (y, x).  On a mesh: start the X and Y strip
    exchanges of every field (packed by shape under `fuse`), run ``fn``
    over the whole block on local pads while they are in flight, then
    re-run it on four thin slabs built from the true halos and patch the
    `width`-wide output bands.  On one block, or with ``overlap=False`` (a
    blocking exchange, then one padded call), it is one padded ``fn``
    call."""
    consts = consts or {}
    if not hx.sharded or not overlap:
        return fn(hx.pad_many(fields, width), consts)

    groups = hx._groups(fields)
    stacked = [torch.stack([fields[n] for n in names]) if len(names) > 1
               else fields[names[0]] for names in groups]
    pending = [hx.exchange_start(a, width) for a in stacked]
    out = fn({k: hx.local_pad(v, width) for k, v in fields.items()}, consts)
    padded: Dict[str, torch.Tensor] = {}
    for names, a, pend in zip(groups, stacked, pending):
        p = hx.exchange_finish(a, pend, width)
        if len(names) == 1:
            padded[names[0]] = p
        else:
            for i, n in enumerate(names):
                padded[n] = p[i]

    v0 = next(iter(fields.values()))
    ny, nx, w = v0.shape[-2], v0.shape[-1], width

    def sel(axis: int, sl: slice):
        """Slice `sl` of trailing axis `axis` (-2 y, -1 x), all of the rest."""
        def f(ndim):
            idx = [slice(None)] * ndim
            idx[ndim + axis] = sl
            return tuple(idx)
        return f

    # y-lo band: padded rows [0, 3w) -> output rows [0, w); likewise the
    # y-hi and the two x bands
    for sel_pad, sel_out in ((sel(-2, slice(0, 3 * w)), sel(-2, slice(0, w))),
                             (sel(-2, slice(ny - w, ny + 2 * w)), sel(-2, slice(ny - w, ny))),
                             (sel(-1, slice(0, 3 * w)), sel(-1, slice(0, w))),
                             (sel(-1, slice(nx - w, nx + 2 * w)), sel(-1, slice(nx - w, nx)))):
        slab = fn({k: v[sel_pad(v.dim())] for k, v in padded.items()},
                  {k: v[sel_out(v.dim())] for k, v in consts.items()})
        for k, o in out.items():
            o[sel_out(o.dim())] = slab[k]
    return out
