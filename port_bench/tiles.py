"""The check of a cell that runs on several cards: the reference follows
the window's last steps in ringed tiles.

One card cannot hold the whole domain of such a cell (config 5's state
alone is 41.6 GB at 1000x1000x60, and the reference's steps need several
times their state), so each rank follows its own block, cut into tiles:

- `extend` gives the rank's block of the port's copied state a ring of
  `RING` cells on every side, from the blocks around it on the mesh, with
  the global domain wrapped periodically (messages on the host, over the
  process group it is given);
- `plan` cuts the block into the fewest tiles whose ringed size fits
  `max_columns`;
- `follow` steps each ringed tile with the reference (its grid cut from
  the reference's global grid with the same wrap), keeps the tile's
  interior, and reduces each field's largest difference and magnitude
  over the tiles (`check.field_maxima`), so that the ranks' pieces join
  into the whole domain's `state_err` (`check.merge_maxima`).

A tile's ring is stepped with wrong neighbours at its outer edge, and the
error travels inward by the reach of a step's stencils.  The interior is
the whole-domain follow bit for bit as long as `RING` is at least the
reach of the followed steps: the cells that a change in one column moves
within them.  Measured with the reference at arc_block's package, 2
steps of 6 s at dx 1 km with 4 acoustic substeps (`reach`;
`test_port_bench_mesh.py` measures it): 12 to 16 cells on the CPU at 12
levels (12 columns), 8 to 11 for one step; on the card at its 60 levels
(`mesh_probe.py tiles`, 8 columns of a 128x128 domain) 19, and 12 for one
step.  The bitwise reach follows the flow (the upwind stencils take their
cells by the wind's sign), so `RING` keeps room: 1.7 times the largest
reach of two steps, more than twice one step's.  A cell whose steps reach
further needs a larger ring.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

RING = 32

# The ringed tile's state bytes that one card's follow is known to hold:
# the one-card cell arc_block.main follows its whole 500x500x60 block
# (126 fields, 41,556 bytes a column) on one card beside nothing else.
FOLLOW_STATE_BYTES = 41_556 * 500 * 500

Tile = Tuple[int, int, int, int]          # y0, y1, x0, x1 in the block


def ring_index(start: int, length: int, ring: int, n: int) -> torch.Tensor:
    """Global indices start - ring .. start + length + ring - 1 along an
    axis of `n` cells, wrapped periodically."""
    return (torch.arange(length + 2 * ring) + (start - ring)) % n


def _splits(n: int, parts: int) -> List[Tuple[int, int]]:
    """`n` cells in `parts` runs as even as can be."""
    edges = [round(i * n / parts) for i in range(parts + 1)]
    return list(zip(edges[:-1], edges[1:]))


def plan(by: int, bx: int, ring: int, max_columns: Optional[int] = None) -> List[Tile]:
    """The block's tiles: of the splits into ty x tx tiles whose ringed
    columns fit `max_columns` (no limit: None), the one with the fewest
    ringed columns in all, then the fewest tiles."""
    best = None
    for ty in range(1, by + 1):
        for tx in range(1, bx + 1):
            h, w = -(-by // ty), -(-bx // tx)
            if max_columns is not None and (h + 2 * ring) * (w + 2 * ring) > max_columns:
                continue
            total = sum((y1 - y0 + 2 * ring) * (x1 - x0 + 2 * ring)
                        for y0, y1 in _splits(by, ty) for x0, x1 in _splits(bx, tx))
            key = (total, ty * tx)
            if best is None or key < best[0]:
                best = (key, ty, tx)
            break       # more x tiles at this ty only add ring
    if best is None:
        raise ValueError(f"no tile of a {by}x{bx} block with a ring of {ring} fits "
                         f"{max_columns} columns")
    _, ty, tx = best
    return [(y0, y1, x0, x1) for y0, y1 in _splits(by, ty) for x0, x1 in _splits(bx, tx)]


def max_columns(device: torch.device, bytes_per_column: int) -> Optional[int]:
    """The ringed columns a tile may have on `device`: on a card, those
    whose state fits `FOLLOW_STATE_BYTES`; on the host, no limit."""
    if device.type != "cuda":
        return None
    return FOLLOW_STATE_BYTES // bytes_per_column


def _runs(g: torch.Tensor, lo: int, n: int) -> List[Tuple[int, int, int]]:
    """Where the global indices `g` (a ringed axis) fall into [lo, lo + n):
    (position in `g`, index from lo, length) of each run of consecutive
    indices, at most two where the ring wraps."""
    inside = ((g >= lo) & (g < lo + n)).tolist()
    runs, gl = [], g.tolist()
    for i, ok in enumerate(inside):
        if not ok:
            continue
        if runs and runs[-1][0] + runs[-1][2] == i and gl[i - 1] + 1 == gl[i]:
            runs[-1][2] += 1
        else:
            runs.append([i, gl[i] - lo, 1])
    return [tuple(r) for r in runs]


def _need(r: int, q: int, mesh: Tuple[int, int], block: Tuple[int, int], ring: int):
    """Where rank q's block lies in rank r's ringed block: the runs of
    rows and of columns (`_runs`: position in r's ringed block, index in
    q's block, length), or None where it does not."""
    (my, mx), (by, bx) = mesh, block
    (ry, rx), (qy, qx) = divmod(r, mx), divmod(q, mx)
    rows = _runs(ring_index(ry * by, by, ring, my * by), qy * by, by)
    cols = _runs(ring_index(rx * bx, bx, ring, mx * bx), qx * bx, bx)
    return (rows, cols) if rows and cols else None


def _piece(t: torch.Tensor, rows, cols) -> torch.Tensor:
    """The cells of `t` (trailing axes y, x) at the runs' indices in q's
    block, in the order of their positions in r's ringed block."""
    out = torch.empty(t.shape[:-2] + (sum(r[2] for r in rows), sum(c[2] for c in cols)),
                      dtype=t.dtype)
    _place(out, t, rows, cols, into_ring=False)
    return out


def _place(dst: torch.Tensor, src: torch.Tensor, rows, cols, into_ring: bool) -> None:
    """Copy run by run: from `src` (q's block when not `into_ring`, else
    a piece) into `dst` (a piece, else r's ringed block)."""
    py = 0
    for pos_y, at_y, ny in rows:
        px = 0
        for pos_x, at_x, nx in cols:
            if into_ring:
                dst[..., pos_y:pos_y + ny, pos_x:pos_x + nx] = src[..., py:py + ny, px:px + nx]
            else:
                dst[..., py:py + ny, px:px + nx] = src[..., at_y:at_y + ny, at_x:at_x + nx]
            px += nx
        py += ny


def extend(block: Dict[str, torch.Tensor], mesh: Tuple[int, int], rank: int, ring: int,
           group=None) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s `block` (host tensors whose trailing axes are the
    block's (y, x), the same names and shapes on every rank of a
    mesh_y x mesh_x `mesh`) with a ring of `ring` cells on every side,
    taken from the blocks around it with the global domain wrapped
    periodically.  Every rank of `group` (a host process group over the
    mesh's ranks; the default one when None) calls it; each sends the
    others the parts of its block in their rings, one message a field (a
    few tens of MB at config 5's block, where one message of every field
    would pass gloo's 2 GiB), cut and placed by runs of rows and columns."""
    names = sorted(block)
    by, bx = block[names[0]].shape[-2:]
    for k in names:
        if block[k].shape[-2:] != (by, bx):
            raise ValueError(f"{k}: trailing axes {tuple(block[k].shape[-2:])}, the block is "
                             f"{(by, bx)}")
    ext = {k: torch.empty(block[k].shape[:-2] + (by + 2 * ring, bx + 2 * ring),
                          dtype=block[k].dtype) for k in names}
    recvs, sends = [], []
    for q in range(mesh[0] * mesh[1]):
        need = _need(rank, q, mesh, (by, bx), ring)
        if need is not None:
            rows, cols = need
            for tag, k in enumerate(names):
                if q == rank:
                    _place(ext[k], _piece(block[k], rows, cols), rows, cols, into_ring=True)
                    continue
                buf = torch.empty(block[k].shape[:-2] + (sum(r[2] for r in rows),
                                                         sum(c[2] for c in cols)),
                                  dtype=block[k].dtype)
                recvs.append((dist.irecv(buf, src=q, group=group, tag=tag), k, buf, rows,
                              cols))
        # what q's ring takes from this rank's block
        need = _need(q, rank, mesh, (by, bx), ring) if q != rank else None
        if need is not None:
            rows, cols = need
            for tag, k in enumerate(names):
                piece = _piece(block[k], rows, cols)
                sends.append((dist.isend(piece, dst=q, group=group, tag=tag), piece))
    for work, k, buf, rows, cols in recvs:
        work.wait()
        _place(ext[k], buf, rows, cols, into_ring=True)
    for work, _ in sends:
        work.wait()
    return ext


def tile_grid(grid, ys: torch.Tensor, xs: torch.Tensor):
    """The reference's `grid` cut to global rows `ys` and columns `xs`:
    every tensor of two axes or more by its trailing (y, x), the vertical
    coordinate's whole."""
    from port_bench.reference.wrf.grid.grid import TENSOR_FIELDS
    cut = {}
    for k in TENSOR_FIELDS:
        t = getattr(grid, k)
        if t.dim() >= 2:
            cut[k] = t.index_select(-2, ys.to(t.device)).index_select(-1, xs.to(t.device))
    return dataclasses.replace(grid, **cut)


def follow(model, grid, ext: Dict[str, torch.Tensor], origin: Tuple[int, int],
           tiles: Sequence[Tile], ring: int, first_step: int, steps: int,
           final: Dict[str, torch.Tensor], device, controls: Sequence = ()) -> dict:
    """The reference (`model`, a `reference.runner.Model`) stepped through
    model steps first_step .. first_step + steps - 1 over each ringed tile
    of `ext` (a block with its ring, from `extend`) whose block starts at
    global (y, x) `origin`, on the reference's global `grid`; each tile's
    interior held to the port's `final` block.  Returns ``{"state":
    field_maxima over the tiles}`` and, for each control model (the
    reference in a lower precision) in `controls`, ``{precision: its
    field_maxima against the reference's tiles}``."""
    from port_bench import check
    ny, nx = grid.ny, grid.nx

    def stepped(m, g, y0, y1, x0, x1):
        s = {k: v[..., y0:y1 + 2 * ring, x0:x1 + 2 * ring].to(device).contiguous()
             for k, v in ext.items()}
        for n in range(first_step, first_step + steps):
            s = m.step(s, g, n)
        return {k: v[..., ring:ring + y1 - y0, ring:ring + x1 - x0].to("cpu")
                for k, v in s.items()}

    parts: Dict[str, list] = {"state": []}
    for y0, y1, x0, x1 in tiles:
        g = tile_grid(grid, ring_index(origin[0] + y0, y1 - y0, ring, ny),
                      ring_index(origin[1] + x0, x1 - x0, ring, nx))
        ref = stepped(model, g, y0, y1, x0, x1)
        port = {k: v[..., y0:y1, x0:x1] for k, v in final.items()}
        parts["state"].append(check.field_maxima(port, ref, device))
        for low_model in controls:
            low = stepped(low_model, g, y0, y1, x0, x1)
            parts.setdefault(low_model.precision, []).append(
                check.field_maxima(low, ref, device))
            del low
        del ref, g
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {k: check.merge_maxima(v) for k, v in parts.items()}


def reach(model, grid, state: Dict[str, torch.Tensor], first_step: int, steps: int,
          columns: Sequence[Tuple[int, int]]) -> int:
    """The reach of the reference's steps first_step .. first_step + steps
    - 1 from `state` (a whole periodic domain): for each (y, x) column of
    `columns`, every field there scaled by 1 + 1e-4 (and moved by 1e-12,
    so that zeros move too), the farthest cell, along y or x with the
    wrap, at which any field then differs by a bit; the largest over the
    columns.  `RING` has to be at least this."""
    ny, nx = grid.ny, grid.nx

    def stepped(s):
        for n in range(first_step, first_step + steps):
            s = model.step(s, grid, n)
        return s

    base = stepped(dict(state))
    far = 0
    for cy, cx in columns:
        moved = {}
        for k, v in state.items():
            v = v.clone()
            v[..., cy, cx] = v[..., cy, cx] * (1 + 1e-4) + 1e-12
            moved[k] = v
        out = stepped(moved)
        hit = torch.zeros(ny, nx, dtype=torch.bool, device=base["t"].device)
        for k, v in out.items():
            hit |= (v != base[k]).reshape(-1, ny, nx).any(0)
        ys, xs = torch.nonzero(hit, as_tuple=True)
        dy = (ys - cy + ny // 2) % ny - ny // 2
        dx = (xs - cx + nx // 2) % nx - nx // 2
        far = max(far, int(torch.maximum(dy.abs(), dx.abs()).max()))
    return far
