"""Rank programs of the process-mesh tests (`test_torch_parallel.py`).

`parallel.launch.spawn` runs each of these in fresh processes, one per
rank of a gloo group on the CPU; each returns numpy results that the test
process holds against the single-block run (and the JAX package).  They
live outside the test module so that a rank imports the port only, not
JAX.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from wrfchem_arc_interactions_tpu_torch.config import (
    ChemConfig, Config, DomainConfig, DynamicsConfig, PhysicsConfig, TimeControl,
)
from wrfchem_arc_interactions_tpu_torch.config.namelist import (
    BCKind, ChemOpt, MPScheme, RAScheme,
)
from wrfchem_arc_interactions_tpu_torch.dycore import solve, stoch
from wrfchem_arc_interactions_tpu_torch.grid.grid import TENSOR_FIELDS, grid_from_numpy
from wrfchem_arc_interactions_tpu_torch.io import history as hio
from wrfchem_arc_interactions_tpu_torch.models import ideal
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
from wrfchem_arc_interactions_tpu_torch.models.lateral_bc import (
    constant_boundary, make_specified_bc,
)
from wrfchem_arc_interactions_tpu_torch.ops.stencil import win
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps, overlap_stencil
from wrfchem_arc_interactions_tpu_torch.parallel.mesh import make_mesh
from wrfchem_arc_interactions_tpu_torch.parallel.sharded import (
    gather, make_sharded_step, place,
)
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy

BCS = ("periodic", "open", "symmetric", "specified")
MESHES = ((1, 2), (2, 1), (2, 2))


def _np(state):
    return None if state is None else {k: v.numpy() for k, v in state.items()}


def _fields(seed=0, ny=12, nx=16):
    """Seeded global fields of three shapes and two dtypes."""
    rng = np.random.default_rng(seed)
    f = {"a": rng.normal(size=(3, ny, nx)), "b": rng.normal(size=(3, ny, nx)),
         "w": rng.normal(size=(4, ny, nx)), "c": rng.normal(size=(ny, nx))}
    out = {k: torch.from_numpy(v.astype(np.float32)) for k, v in f.items()}
    out["d"] = torch.from_numpy(rng.normal(size=(3, ny, nx)))           # float64
    return out


def plus_stencil(padded, consts):
    """A plus-shaped width-1 stencil (gradient and Laplacian), as
    `tests/test_overlap_pallas.py::_plus_stencil`."""
    a, b = padded["a"], padded["b"]
    gx = win(a, 0, 0, pad=1) - win(a, 0, -1, pad=1)
    gy = win(a, -1, 0, pad=1) - win(a, 0, 0, pad=1)
    lap = (win(b, 0, 1, pad=1) + win(b, 0, -1, pad=1) + win(b, 1, 0, pad=1)
           + win(b, -1, 0, pad=1) - 4.0 * win(b, 0, 0, pad=1))
    return {"out": gx + 0.5 * gy + consts["c"] * lap, "gx": gx}


def _window(mesh, a, h=0):
    ys, xs = mesh.window(a.shape[-2] - 2 * h, a.shape[-1] - 2 * h)
    return a[..., ys.start:ys.stop + 2 * h, xs.start:xs.stop + 2 * h]


def halo_suite(rank, device):
    """4 ranks: halo pads on (1,2) and (2,1) meshes (subgroups of two
    ranks) and on the (2,2) mesh for every boundary kind with halo_fuse on
    and off, the block-smaller-than-halo error, `overlap_stencil`, psum /
    pmax, `white_noise`, the relax zone and `gather`."""
    torch.set_num_threads(1)
    res = {}
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    meshes = {(1, 2): make_mesh(1, 2, group=pairs[rank // 2], device="cpu"),
              (2, 1): make_mesh(2, 1, group=pairs[rank // 2], device="cpu"),
              (2, 2): make_mesh(2, 2, device="cpu")}
    f = _fields()
    for shape, mesh in meshes.items():
        for bc in BCS:
            one = HaloOps(BCKind(bc), BCKind(bc))
            for fuse in (True, False):
                hx = HaloOps(BCKind(bc), BCKind(bc), mesh=mesh, fuse=fuse)
                sent = mesh.exchanges
                got = hx.pad_many({k: mesh.cut(v) for k, v in f.items()}, 3)
                ok = all(torch.equal(got[k], _window(mesh, one.pad(v, 3), 3))
                         for k, v in f.items())
                ok = ok and torch.equal(hx.pad(mesh.cut(f["a"]), 1),
                                        _window(mesh, one.pad(f["a"], 1), 1))
                res[("pad", shape, bc, fuse)] = (ok, mesh.exchanges - sent)
    m22 = meshes[(2, 2)]
    try:
        HaloOps(BCKind.PERIODIC, BCKind.PERIODIC, mesh=m22).pad(m22.cut(f["a"][:, :8, :8]), 5)
        res["small"] = None
    except ValueError as e:
        res["small"] = str(e)
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.normal(size=(4, 8, 16)).astype(np.float32)) for _ in "ab")
    c = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    for bc in ("periodic", "open"):
        one = HaloOps(BCKind(bc), BCKind(bc))
        ref = plus_stencil({"a": one.pad(a, 1), "b": one.pad(b, 1)}, {"c": c})
        hx = HaloOps(BCKind(bc), BCKind(bc), mesh=m22)
        for overlap in (True, False):
            out = overlap_stencil(hx, {"a": m22.cut(a), "b": m22.cut(b)}, 1, plus_stencil,
                                  {"c": m22.cut(c)}, overlap=overlap)
            res[("overlap", bc, overlap)] = max(
                float((out[k] - _window(m22, ref[k])).abs().max()) for k in ref)
    hx = HaloOps(mesh=m22)
    x = torch.tensor([float(rank + 1), -float(rank)])
    res["psum"] = hx.psum(x).tolist()
    res["pmax"] = hx.pmax(x).tolist()
    noise = stoch.white_noise((6, 8), 17, 3, hx=hx)
    res["noise"] = torch.equal(noise, _window(m22, stoch.white_noise((12, 16), 17, 3)))
    res["relax"] = _relax(m22)
    res["polar"] = _polar(meshes[(2, 1)])
    g = gather({"a": m22.cut(f["a"]), "c": m22.cut(f["c"]), "d": m22.cut(f["d"])}, m22)
    res["gather"] = None if g is None else all(torch.equal(g[k], f[k]) for k in g)
    return res


def _relax(mesh):
    """The Davies zones on a block (its masks and boundary data cut from the
    global ones, the Laplacian's halo exchanged at seams) against the global
    operator's window, bit for bit, on a specified x and a periodic y."""
    cfg = Config(domain=DomainConfig(nx=16, ny=12, nz=3, dx=1000.0, dy=1000.0),
                 dynamics=DynamicsConfig(bc_x=BCKind.SPECIFIED, bc_y=BCKind.PERIODIC))
    rng = np.random.default_rng(5)
    state = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for k, s in (("u", (3, 12, 16)), ("t", (3, 12, 16)), ("mu", (12, 16)))}
    tgt = {k: v + 1.0 for k, v in state.items()}

    class G:
        device = torch.device("cpu")

    one = make_specified_bc(cfg, G(), names=("u", "t", "mu"))
    ref = one.apply(state, constant_boundary(tgt), 0.0, 10.0)
    blk = make_specified_bc(cfg, G(), names=("u", "t", "mu"), mesh=mesh)
    hx = HaloOps(BCKind.SPECIFIED, BCKind.PERIODIC, mesh=mesh)
    out = blk.apply({k: mesh.cut(v) for k, v in state.items()},
                    constant_boundary({k: mesh.cut(v) for k, v in tgt.items()}), 0.0, 10.0,
                    hx=hx)
    return all(torch.equal(out[k], mesh.cut(ref[k])) for k in ref)


def _polar(mesh):
    """The polar filter's row masks on a (2, 1) mesh: a block's mass and v
    rows (the v face below the block's first row reads the latitude of the
    row below, on the block beneath) are the global masks' rows."""
    from wrfchem_arc_interactions_tpu_torch.dycore.polar_filter import PolarFilter

    class G:
        def __init__(self, xlat):
            self.xlat = xlat

    lat = torch.linspace(-80.0, 80.0, 12)[:, None].expand(12, 16).contiguous()
    one = PolarFilter(G(lat), 45.0, 16)
    blk = PolarFilter(G(mesh.cut(lat)), 45.0, 16, HaloOps(BCKind.PERIODIC, BCKind.OPEN,
                                                          mesh=mesh))
    ys, _ = mesh.window(12, 16)
    return all(torch.equal(getattr(blk, k), getattr(one, k)[ys])
               for k in ("mask_m", "mask_m_taper", "mask_v"))


def bubble_cfg(overlap=True):
    """`tests/test_parallel.py::_case`'s configuration in the port."""
    return Config(domain=DomainConfig(nx=32, ny=8, nz=12, dx=500.0, dy=500.0,
                                      ztop=10000.0, p_top=26000.0),
                  time_control=TimeControl(dt=3.0),
                  dynamics=DynamicsConfig(overlap_halo=overlap))


def dycore_suite(rank, device, state_np, grid_np):
    """4 ranks: the warm bubble's dycore step, 3 steps on (1,4) and (2,2)
    from the given global state and grid (the JAX package's, carried
    over), and on (2,2) with overlap_halo off; gathered on rank 0."""
    torch.set_num_threads(1)
    out = {}
    for shape, overlap in (((1, 4), True), ((2, 2), True), ((2, 2), False)):
        cfg = bubble_cfg(overlap)
        mesh = make_mesh(*shape, device="cpu")
        grid, state = grid_from_numpy(grid_np, "cpu"), state_from_numpy(state_np, "cpu")
        step, place_in = make_sharded_step(cfg, grid, mesh, solve.step, 3.0)
        s, g = place_in(state, grid)
        for _ in range(3):
            s = step(s, g)
        out[(shape, overlap)] = _np(gather(s, mesh))
    return out


def arc_case(nx=16, ny=8, nz=10, dtype=torch.float32):
    """`tests/test_parallel.py::_arc_case` in the port: Morrison with
    activation, RRTMG and CBM-Z with MOSAIC 4-bin, radiation and chemistry
    every step, seeded aerosol and gases."""
    cfg = Config(
        domain=DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                            ztop=12000.0, p_top=20000.0),
        time_control=TimeControl(dt=4.0),
        dynamics=DynamicsConfig(kvdif=20.0),
        physics=PhysicsConfig(mp_physics=MPScheme.MORRISON2, progn=True,
                              ra_sw_physics=RAScheme.RRTMG, ra_lw_physics=RAScheme.RRTMG,
                              radt_s=4.0),
        chem=ChemConfig(chem_opt=ChemOpt.CBMZ_MOSAIC_4BIN, chemdt_s=4.0,
                        aer_ra_feedback=True))
    grid, state = ideal.make_case(cfg, "warm_bubble", device="cpu", amplitude=2.0,
                                  zc=1500.0, xr=2500.0, zr=1200.0, three_d=True)
    for b in (1, 2):
        state[f"chem_so4_a{b:02d}"] = torch.full_like(state["t"], 3.0)
        state[f"chem_num_a{b:02d}"] = torch.full_like(state["t"], 5e9)
    for s, v in (("o3", 0.04), ("no2", 2e-3), ("no", 1e-3), ("co", 0.12),
                 ("so2", 2e-3), ("h2o2", 1e-3), ("hcho", 2e-3)):
        state[f"chem_{s}"] = torch.full_like(state["t"], v)
    if dtype != torch.float32:
        state = {k: v.to(dtype) for k, v in state.items()}
        grid = dataclasses.replace(grid, **{k: getattr(grid, k).to(dtype)
                                            for k in TENSOR_FIELDS})
    return cfg, grid, state


def plain_kernels_float64():
    """The kernels' plain versions where the step calls the wrappers (the
    wrappers take float32 only): float64 runs on the CPU."""
    from wrfchem_arc_interactions_tpu_torch.chem import optics
    from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel, mie_kernel, tracers_kernel
    solve.advect_scalar_5_3 = adv_kernel.advect_scalar_5_3_reference
    solve.advect_tracers = tracers_kernel.advect_tracers_reference
    optics.cheb_eval = mie_kernel.cheb_eval_reference


def run_arc(mesh, dtype, n_steps):
    """The full ARC step of `arc_case` (float32 at 16x8x10, float64 at
    8x8x8) for `n_steps` on `mesh` (None: one block); the global state."""
    if dtype == torch.float64:
        plain_kernels_float64()
        cfg, grid, state = arc_case(8, 8, 8, dtype)
    else:
        cfg, grid, state = arc_case()
    sim = Simulation(cfg, grid, state, mesh=mesh, device="cpu")
    sim.advance(n_steps)
    return _np(sim.gather_state())


def arc_suite(rank, device):
    torch.set_num_threads(1)
    mesh = make_mesh(2, 2, device="cpu")
    return {"f32": run_arc(mesh, torch.float32, 2), "f64": run_arc(mesh, torch.float64, 1),
            "exchanges": mesh.exchanges}


TS_POINTS = (("sw", 1, 2), ("ne", 6, 29), ("mid", 4, 16))


def sim_cfg(out_every_s=0.0, ts=False):
    cfg = bubble_cfg()
    tc = dataclasses.replace(cfg.time_control, history_interval_s=out_every_s,
                             restart_interval_s=out_every_s,
                             auxhist_interval_s=out_every_s,
                             ts_points=TS_POINTS if ts else ())
    return cfg.replace(time_control=tc)


def bubble_case(cfg):
    return ideal.make_case(cfg, "warm_bubble", device="cpu", amplitude=2.0, zc=1500.0,
                           xr=2500.0, zr=1200.0, three_d=True)


def simulation_suite(rank, device, out_dir):
    """4 ranks on (2,2): the output streams written from the placed step-0
    state, then 2 steps with output every 2 steps and tslist (a restart at
    step 2), a read of that restart into the blocks, and the NaN check
    raising on every rank."""
    torch.set_num_threads(1)
    mesh = make_mesh(2, 2, device="cpu")
    res = {}
    cfg = sim_cfg(6.0, ts=True)
    grid, state = bubble_case(cfg)
    sim = Simulation(cfg, grid, state, mesh=mesh, output_dir=os.path.join(out_dir, "step0"))
    sim._write_output()
    sim.output_dir = os.path.join(out_dir, "run")
    sim.advance(2)
    res["ts"] = sim.ts_series
    blocks = dict(sim.state)
    path = os.path.join(out_dir, "run", f"restart_000002{hio.default_extension()}")
    hio.flush()
    mesh.barrier()
    back, step, t = hio.read_restart(path, cfg, {k: torch.zeros_like(v)
                                                 for k, v in blocks.items()}, mesh)
    res["restart_read"] = (step, t, all(torch.equal(back[k], blocks[k])
                                        for k in hio.restart_names(cfg)))
    res["state"] = _np(sim.gather_state())
    # theta goes non-finite on one block: every rank raises
    bad = dict(sim.state)
    if rank == 1:
        bad["t"] = bad["t"].clone()
        bad["t"][0, 0, 0] = float("nan")
    sim.state = bad
    sim.check_nans = True
    try:
        sim.advance(1)
        res["nan"] = None
    except FloatingPointError as e:
        res["nan"] = str(e)
    return res


def spawn_failure(rank, device):
    """Rank 1 fails at once; rank 0 waits for a message it never gets."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    buf = torch.zeros(1)
    dist.recv(buf, src=1)
    return float(buf)


def mesh_errors(rank, device):
    """The mesh's own refusals: a group of the wrong size, an uneven split."""
    out = {}
    for args in ((2, 2), (1, 3)):
        try:
            make_mesh(*args, device="cpu")
            out[args] = None
        except ValueError as e:
            out[args] = str(e)
    mesh = make_mesh(1, 2, device="cpu")
    try:
        cfg = Config(domain=DomainConfig(nx=9, ny=4, nz=3))
        place({}, ideal.make_case(cfg, "warm_bubble", device="cpu")[0], mesh, cfg)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out
