"""Nested domains: one-way and two-way horizontal nesting (port of the JAX
package's `models/nest.py`; canonical frame/module_nesting.F,
share/interp_fcn.F and the recursive child walk of
frame/module_integrate.F).

A child domain sits at 3:1 (or another) refinement inside its parent.
Each parent step (1) interpolates the parent fields before and after the
step to the child's boundary (the wrfbdy-like forcing), (2) advances the
child `ratio` steps with specified/relaxation lateral boundaries, and (3)
with two-way feedback replaces the overlapped parent cells by the child
solution averaged over each parent cell.

- Interpolation: parent -> child bilinear interpolation is a fixed linear
  map, two small dense matrices (child = Wy @ field @ Wx^T, an einsum over
  the z batch), with separate matrices for the u/v face staggering (u at
  west faces: position i, mass at i + 0.5).
- Boundary forcing reuses the Davies zones (`models.lateral_bc`): the two
  bracketing snapshots are the parent state before and after its step.
- Feedback (two-way) block-averages the child's ratio x ratio cells onto
  the overlapped parent region, leaving out the child's spec and relax
  zones.
- Moving nests (`NestedSimulation.move`) shift the child window by whole
  parent cells: the child content is rolled by ratio * shift (exact, the
  grids align), the newly exposed strips are filled from the parent, and
  the interpolation matrices are rebuilt.  `follow_max_w` recentres the
  window on the parent's strongest updraft.  Moving nests need flat
  terrain, as in the reference.

The child shares the parent's vertical levels and physics configuration,
the reference's constraint.

On a process mesh (``mesh=parallel.mesh.make_mesh(...)``, forwarded to
both Simulations as the reference does) each rank steps its block of the
parent and of the child.  The nest's operators stay global, as the
reference runs them outside its `shard_map` regions: every rank gathers
the whole fields they read (`parallel.sharded.all_gather_fields`), applies
exactly the operator of the one-block run, and keeps its own block (the
child's `boundary` setter and `place_state` cut it).  So a nest on a mesh
equals the one-block nest bit for bit, through one code path.  Every rank
must call `advance`, `move` and `follow_max_w` in the same order: each
gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
from wrfchem_arc_interactions_tpu_torch.grid.grid import make_grid
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
from wrfchem_arc_interactions_tpu_torch.models.lateral_bc import LateralBoundary
from wrfchem_arc_interactions_tpu_torch.parallel.mesh import block_shape
from wrfchem_arc_interactions_tpu_torch.parallel.sharded import all_gather_fields, place_state
from wrfchem_arc_interactions_tpu_torch.registry.state import (
    build_state, halo_width, restart_names,
)


@dataclasses.dataclass(frozen=True)
class NestSpec:
    """Child placement in parent mass-point index space: the child covers
    parent cells [i_start, i_start + nx_parent_cells) x [j_start, j_start +
    ny_parent_cells) with `ratio` child cells per parent cell and direction."""

    i_start: int
    j_start: int
    nx_parent_cells: int
    ny_parent_cells: int
    ratio: int = 3

    @property
    def cnx(self) -> int:
        return self.nx_parent_cells * self.ratio

    @property
    def cny(self) -> int:
        return self.ny_parent_cells * self.ratio


def _interp_matrix(n_parent: int, start: int, n_child: int, ratio: int,
                   stagger: bool) -> np.ndarray:
    """(n_child, n_parent) float32 1D linear-interpolation matrix.  Child
    point c sits at parent coordinate start + (c + 0.5)/ratio (mass) or
    start + c/ratio (face); parent mass points at i + 0.5, faces at i."""
    w = np.zeros((n_child, n_parent), np.float32)
    for cindex in range(n_child):
        if stagger:
            xi = start + cindex / ratio     # face coordinates align
        else:
            xi = start + (cindex + 0.5) / ratio - 0.5
        i0 = int(np.floor(xi))
        frac = xi - i0
        i0c = min(max(i0, 0), n_parent - 1)
        i1c = min(max(i0 + 1, 0), n_parent - 1)
        w[cindex, i0c] += 1.0 - frac
        w[cindex, i1c] += frac
    return w


class ParentToChild:
    """Dense-matrix interpolator for whole state dicts (matrices kept on
    the host, moved to each field's device and type when applied)."""

    def __init__(self, spec: NestSpec, pny: int, pnx: int):
        s = spec
        mats = {("x", False): (pnx, s.i_start, s.cnx), ("x", True): (pnx, s.i_start, s.cnx),
                ("y", False): (pny, s.j_start, s.cny), ("y", True): (pny, s.j_start, s.cny)}
        self._w = {key: torch.from_numpy(_interp_matrix(n, start, nc, s.ratio, key[1]))
                   for key, (n, start, nc) in mats.items()}
        self._on: Dict[tuple, torch.Tensor] = {}

    def _mat(self, axis: str, stagger: bool, like: torch.Tensor) -> torch.Tensor:
        key = (axis, stagger, like.device, like.dtype)
        if key not in self._on:
            self._on[key] = self._w[(axis, stagger)].to(device=like.device, dtype=like.dtype)
        return self._on[key]

    def field(self, a: torch.Tensor, name: str) -> torch.Tensor:
        """`a` (..., pny, pnx) on the child's (..., cny, cnx): any leading
        axes, the band-resolved optics' (band, z) too, where the reference's
        form takes at most one."""
        wx = self._mat("x", name == "u", a)
        wy = self._mat("y", name == "v", a)
        return torch.einsum("Yy,...yx,Xx->...YX", wy, a, wx)

    def state(self, state: Dict[str, torch.Tensor], names) -> Dict[str, torch.Tensor]:
        return {n: self.field(state[n], n) for n in names if n in state}


def child_config(cfg: Config, spec: NestSpec) -> Config:
    """The child's namelist: refined dx and dt, specified lateral
    boundaries, the same physics, chemistry and vertical levels."""
    d = cfg.domain
    tc = cfg.time_control
    return dataclasses.replace(
        cfg,
        domain=dataclasses.replace(d, nx=spec.cnx, ny=spec.cny,
                                   dx=d.dx / spec.ratio, dy=d.dy / spec.ratio),
        time_control=dataclasses.replace(tc, dt=tc.dt / spec.ratio),
        dynamics=dataclasses.replace(cfg.dynamics, bc_x=BCKind.SPECIFIED,
                                     bc_y=BCKind.SPECIFIED),
    )


def _steady(snap: Dict[str, torch.Tensor], t0: float) -> LateralBoundary:
    """A boundary held at `snap` from model time `t0` (float32, as the
    reference's clock)."""
    t0 = float(np.float32(t0))
    return LateralBoundary(lo=snap, hi=snap, t_lo=t0, t_hi=float(np.float32(t0 + 1.0)))


def _check_child_split(cfg_child: Config, mesh) -> None:
    """Refuse, with a message, a child that the mesh does not split evenly
    or whose blocks are narrower than the halo.  Every rank reaches the
    same verdict from the same arguments before any collective, so none is
    left waiting in a gather."""
    d = cfg_child.domain
    try:
        by, bx = block_shape(d.ny, d.nx, mesh)
    except ValueError as e:
        raise ValueError(f"the child domain: {e}") from None
    width = halo_width(cfg_child)
    if min(by, bx) < width:
        raise ValueError(f"the child's ({d.ny}, {d.nx}) cells on a ({mesh.mesh_y}, "
                         f"{mesh.mesh_x}) mesh make ({by}, {bx}) blocks, narrower than "
                         f"the halo width {width}")


class NestedSimulation:
    """Parent and one child domain, advanced in the reference's order:
    parent step -> child boundary bracketing -> `ratio` child steps ->
    optional two-way feedback.  `sim_kw` (``device`` and ``mesh`` among
    them) go to both `Simulation`s; under a mesh every rank passes the
    same global `grid` and `state`."""

    def __init__(self, cfg: Config, grid, state, spec: NestSpec,
                 theta_of_z: Callable, feedback: bool = False,
                 forced_names: Optional[Tuple[str, ...]] = None,
                 p_surf: Optional[float] = None, **sim_kw):
        self.spec = spec
        self.feedback = feedback
        self.mesh = sim_kw.get("mesh")
        self.cfg_child = child_config(cfg, spec)
        if self.mesh is not None:
            _check_child_split(self.cfg_child, self.mesh)
        self.parent = Simulation(cfg, grid, state, **sim_kw)
        dev = self.parent.device
        dtype = grid.mub.dtype
        self.interp = ParentToChild(spec, cfg.domain.ny, cfg.domain.nx)

        # child grid: the same sounding and top; terrain interpolated from
        # the parent's (the global grid's: under a mesh the parent's is a
        # block)
        ht_c = self.interp.field(grid.ht.to(dev), "ht").cpu().numpy()
        self._flat = float(np.abs(ht_c).max()) == 0.0
        grid_kw = {} if p_surf is None else {"p_surf": p_surf}
        self.grid_child = make_grid(
            self.cfg_child, theta_of_z, dev, terrain=None if self._flat else ht_c,
            f0=float(grid.f.flatten()[0]), dtype=dtype, **grid_kw)

        if forced_names is None:
            forced_names = ("u", "v", "w", "t", "mu", "ph") + cfg.moist_species()
        self.forced_names = forced_names
        # the child starts from every restart field of the parent (chem
        # tracers included) interpolated; the rest from the registry's zeros
        glob = self._parent_global(restart_names(cfg))
        base = build_state(self.cfg_child, dev, dtype)
        base.update(self.interp.state(glob, restart_names(cfg)))
        snap = self.interp.state(glob, self.forced_names)
        del glob
        self.child = Simulation(self.cfg_child, self.grid_child, base,
                                boundary=_steady(snap, self.parent.time_s), **sim_kw)

    def _parent_global(self, names) -> Dict[str, torch.Tensor]:
        """The parent's fields `names` whole, on every rank (a collective
        under a mesh)."""
        st = self.parent.state
        return all_gather_fields({n: st[n] for n in names if n in st}, self.mesh)

    # -- feedback ---------------------------------------------------------
    def _feedback(self, parent_forced: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Average the child's (ratio x ratio) blocks back onto the parent,
        leaving out the child's boundary zones.  `parent_forced` holds the
        parent's forced fields whole; returns them after the feedback."""
        r = self.spec.ratio
        dyn = self.cfg_child.dynamics
        skip = dyn.spec_zone + dyn.relax_zone          # child cells
        skip_p = -(-skip // r) + 1                     # parent cells to skip
        s = self.spec
        cs = self.child.state
        cs = all_gather_fields({n: cs[n] for n in self.forced_names if n in cs}, self.mesh)
        out = dict(parent_forced)
        for n, a in cs.items():
            if n == "u":
                # parent u face i_p maps to child face (i_p - i_start) * r
                cols = a[..., ::r]
                blk = cols.reshape(a.shape[:-2] + (s.ny_parent_cells, r, -1)).mean(-2)
            elif n == "v":
                rows = a[..., ::r, :]
                blk = rows.reshape(a.shape[:-2] + (s.ny_parent_cells, -1, r)).mean(-1)
            else:
                blk = a.reshape(a.shape[:-2] + (s.ny_parent_cells, r,
                                                s.nx_parent_cells, r)).mean((-3, -1))
            j0, i0 = s.j_start + skip_p, s.i_start + skip_p
            j1 = s.j_start + s.ny_parent_cells - skip_p
            i1 = s.i_start + s.nx_parent_cells - skip_p
            sub = blk[..., skip_p:s.ny_parent_cells - skip_p,
                      skip_p:s.nx_parent_cells - skip_p]
            p = out[n].clone()
            p[..., j0:j1, i0:i1] = sub.to(p.dtype)
            out[n] = p
        fed = {n: out[n] for n in cs}
        if self.mesh is not None:                      # each rank keeps its block
            fed = place_state(fed, self.mesh, self.parent.cfg)
        self.parent.state = {**self.parent.state, **fed}
        return out

    # -- moving nest ------------------------------------------------------
    def move(self, di: int, dj: int):
        """Shift the child window by (di, dj) parent cells: the child's
        content moves by (-di*ratio, -dj*ratio) child cells (the window
        slides over the fluid), and the strips exposed on the leading edge
        are filled from the parent."""
        if not self._flat:
            raise NotImplementedError("moving nests require flat terrain")
        s = self.spec
        pny, pnx = self.parent._ny, self.parent._nx
        ni = s.i_start + di
        nj = s.j_start + dj
        if not (0 <= ni and ni + s.nx_parent_cells <= pnx
                and 0 <= nj and nj + s.ny_parent_cells <= pny):
            raise ValueError("move would push the child outside the parent")
        self.spec = dataclasses.replace(s, i_start=ni, j_start=nj)
        self.interp = ParentToChild(self.spec, pny, pnx)
        r = s.ratio
        sx, sy = di * r, dj * r
        cny, cnx = s.cny, s.cnx
        glob = self._parent_global(
            dict.fromkeys(restart_names(self.parent.cfg) + tuple(self.forced_names)))
        fresh = self.interp.state(glob, restart_names(self.parent.cfg))
        dev = self.parent.device
        ii = torch.arange(cnx, device=dev)
        jj = torch.arange(cny, device=dev)
        new_x = (ii >= cnx - sx) if sx > 0 else (ii < -sx)
        new_y = (jj >= cny - sy) if sy > 0 else (jj < -sy)
        newly = new_x[None, :] | new_y[:, None]          # (cny, cnx)
        out = {}
        for n, a in all_gather_fields(self.child.state, self.mesh).items():
            b = torch.roll(a, (-sy, -sx), dims=(-2, -1))
            out[n] = torch.where(newly, fresh[n].to(a.dtype), b) if n in fresh else b
        del fresh
        self.child.state = out if self.mesh is None else place_state(out, self.mesh,
                                                                     self.cfg_child)
        # re-centre the boundary forcing on the new window at once
        snap = self.interp.state(glob, self.forced_names)
        self.child.boundary = _steady(snap, self.parent.time_s)

    def follow_max_w(self, threshold_cells: int = 2):
        """Recentre the child window on the parent column with the strongest
        updraft, at most one parent cell per call and axis (the
        vortex-following analog).  Ties go to the first column in row-major
        order, on a mesh too: every rank offers its block's strongest column
        with its global index, and all take the same one."""
        col = torch.amax(torch.abs(self.parent.state["w"]), dim=0)
        pny, pnx = self.parent._ny, self.parent._nx
        k = int(torch.argmax(col))
        if self.mesh is not None:
            ys, xs = self.mesh.window(pny, pnx)
            jb, ib = divmod(k, col.shape[-1])
            mine = torch.tensor([float(col.flatten()[k]),
                                 float((ys.start + jb) * pnx + xs.start + ib)],
                                dtype=torch.float64)
            offers = torch.stack([o.cpu() for o in self.mesh.all_gather(mine)])
            best = offers[:, 0].max()
            k = int(offers[offers[:, 0] == best, 1].min())
        j, i = divmod(k, pnx)
        s = self.spec
        ci = s.i_start + s.nx_parent_cells // 2
        cj = s.j_start + s.ny_parent_cells // 2
        di = int(np.clip(i - ci, -1, 1)) if abs(i - ci) > threshold_cells else 0
        dj = int(np.clip(j - cj, -1, 1)) if abs(j - cj) > threshold_cells else 0
        if di or dj:
            ni = np.clip(s.i_start + di, 0, pnx - s.nx_parent_cells)
            nj = np.clip(s.j_start + dj, 0, pny - s.ny_parent_cells)
            di, dj = int(ni - s.i_start), int(nj - s.j_start)
            if di or dj:
                self.move(di, dj)
        return di, dj

    # -- time stepping ----------------------------------------------------
    def advance(self, n_parent_steps: int):
        """`n_parent_steps` parent steps, each bracketing the child's
        boundary by the parent's forced fields before and after it; the
        whole fields after one step (and its feedback) are the next one's
        start."""
        r = self.spec.ratio
        forced = None
        for _ in range(n_parent_steps):
            if forced is None:
                forced = self._parent_global(self.forced_names)
            snap_lo = self.interp.state(forced, self.forced_names)
            t_lo = self.parent.time_s
            self.parent.advance(1)
            forced = self._parent_global(self.forced_names)
            snap_hi = self.interp.state(forced, self.forced_names)
            self.child.boundary = LateralBoundary(
                lo=snap_lo, hi=snap_hi, t_lo=float(np.float32(t_lo)),
                t_hi=float(np.float32(self.parent.time_s)))
            del snap_lo, snap_hi
            self.child.advance(r)
            if self.feedback:
                forced = self._feedback(forced)

    @property
    def time_s(self) -> float:
        return self.parent.time_s
