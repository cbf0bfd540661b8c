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
the reference's constraint.  A nest on a process mesh (the reference
forwards ``mesh=`` to both Simulations) is not ported yet and raises.
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
from wrfchem_arc_interactions_tpu_torch.registry.state import build_state, restart_names
from wrfchem_arc_interactions_tpu_torch.utils.support import SLICE_MESH, unported


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
        wx = self._mat("x", name == "u", a)
        wy = self._mat("y", name == "v", a)
        if a.dim() == 2:
            return torch.einsum("Yy,yx,Xx->YX", wy, a, wx)
        return torch.einsum("Yy,zyx,Xx->zYX", wy, a, wx)

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


class NestedSimulation:
    """Parent and one child domain, advanced in the reference's order:
    parent step -> child boundary bracketing -> `ratio` child steps ->
    optional two-way feedback.  `sim_kw` (``device`` among them) go to both
    `Simulation`s."""

    def __init__(self, cfg: Config, grid, state, spec: NestSpec,
                 theta_of_z: Callable, feedback: bool = False,
                 forced_names: Optional[Tuple[str, ...]] = None,
                 p_surf: Optional[float] = None, **sim_kw):
        if sim_kw.get("mesh") is not None:
            raise unported("a nest on a process mesh", SLICE_MESH)
        self.spec = spec
        self.feedback = feedback
        self.parent = Simulation(cfg, grid, state, **sim_kw)
        dev = self.parent.device
        self.cfg_child = child_config(cfg, spec)
        self.interp = ParentToChild(spec, cfg.domain.ny, cfg.domain.nx)

        # child grid: the same sounding and top; terrain interpolated from
        # the parent's
        ht_c = self.interp.field(self.parent.grid.ht, "ht").cpu().numpy()
        grid_kw = {} if p_surf is None else {"p_surf": p_surf}
        self.grid_child = make_grid(
            self.cfg_child, theta_of_z, dev,
            terrain=ht_c if float(np.abs(ht_c).max()) > 0.0 else None,
            f0=float(self.parent.grid.f.flatten()[0]), dtype=self.parent.grid.mub.dtype,
            **grid_kw)

        if forced_names is None:
            forced_names = ("u", "v", "w", "t", "mu", "ph") + cfg.moist_species()
        self.forced_names = forced_names
        # the child starts from every restart field of the parent (chem
        # tracers included) interpolated; the rest from the registry's zeros
        child_state = self.interp.state(self.parent.state, restart_names(cfg))
        base = build_state(self.cfg_child, dev, self.parent.grid.mub.dtype)
        base.update(child_state)

        snap = self.interp.state(self.parent.state, self.forced_names)
        self.child = Simulation(self.cfg_child, self.grid_child, base,
                                boundary=_steady(snap, self.parent.time_s), **sim_kw)

    # -- feedback ---------------------------------------------------------
    def _feedback(self):
        """Average the child's (ratio x ratio) blocks back onto the parent,
        leaving out the child's boundary zones."""
        r = self.spec.ratio
        dyn = self.cfg_child.dynamics
        skip = dyn.spec_zone + dyn.relax_zone          # child cells
        skip_p = -(-skip // r) + 1                     # parent cells to skip
        s = self.spec
        out = dict(self.parent.state)
        cs = self.child.state
        for n in self.forced_names:
            if n not in cs:
                continue
            a = cs[n]
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
        self.parent.state = out

    # -- moving nest ------------------------------------------------------
    def move(self, di: int, dj: int):
        """Shift the child window by (di, dj) parent cells: the child's
        content moves by (-di*ratio, -dj*ratio) child cells (the window
        slides over the fluid), and the strips exposed on the leading edge
        are filled from the parent."""
        if float(self.grid_child.ht.abs().max()) > 0.0:
            raise NotImplementedError("moving nests require flat terrain")
        s = self.spec
        pny, pnx = self.parent.grid.ny, self.parent.grid.nx
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
        fresh = self.interp.state(self.parent.state, restart_names(self.parent.cfg))
        dev = self.parent.device
        ii = torch.arange(cnx, device=dev)
        jj = torch.arange(cny, device=dev)
        new_x = (ii >= cnx - sx) if sx > 0 else (ii < -sx)
        new_y = (jj >= cny - sy) if sy > 0 else (jj < -sy)
        newly = new_x[None, :] | new_y[:, None]          # (cny, cnx)
        out = {}
        for n, a in self.child.state.items():
            b = torch.roll(a, (-sy, -sx), dims=(-2, -1))
            out[n] = torch.where(newly, fresh[n].to(a.dtype), b) if n in fresh else b
        self.child.state = out
        # re-centre the boundary forcing on the new window at once
        snap = self.interp.state(self.parent.state, self.forced_names)
        self.child.boundary = _steady(snap, self.parent.time_s)

    def follow_max_w(self, threshold_cells: int = 2):
        """Recentre the child window on the parent column with the strongest
        updraft, at most one parent cell per call and axis (the
        vortex-following analog)."""
        col = torch.amax(torch.abs(self.parent.state["w"]), dim=0)
        j, i = np.unravel_index(int(torch.argmax(col)), tuple(col.shape))
        s = self.spec
        ci = s.i_start + s.nx_parent_cells // 2
        cj = s.j_start + s.ny_parent_cells // 2
        di = int(np.clip(i - ci, -1, 1)) if abs(i - ci) > threshold_cells else 0
        dj = int(np.clip(j - cj, -1, 1)) if abs(j - cj) > threshold_cells else 0
        if di or dj:
            ni = np.clip(s.i_start + di, 0, self.parent.grid.nx - s.nx_parent_cells)
            nj = np.clip(s.j_start + dj, 0, self.parent.grid.ny - s.ny_parent_cells)
            di, dj = int(ni - s.i_start), int(nj - s.j_start)
            if di or dj:
                self.move(di, dj)
        return di, dj

    # -- time stepping ----------------------------------------------------
    def advance(self, n_parent_steps: int):
        r = self.spec.ratio
        for _ in range(n_parent_steps):
            snap_lo = self.interp.state(self.parent.state, self.forced_names)
            t_lo = self.parent.time_s
            self.parent.advance(1)
            snap_hi = self.interp.state(self.parent.state, self.forced_names)
            self.child.boundary = LateralBoundary(
                lo=snap_lo, hi=snap_hi, t_lo=float(np.float32(t_lo)),
                t_hi=float(np.float32(self.parent.time_s)))
            self.child.advance(r)
            if self.feedback:
                self._feedback()

    @property
    def time_s(self) -> float:
        return self.parent.time_s
