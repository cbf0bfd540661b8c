"""The port's domain decomposition over a process mesh, on the CPU.

Mirrors ``tests/test_parallel.py``, the overlap test of
``tests/test_overlap_pallas.py`` and ``tests/test_multihost.py``: ranks are
processes joined by `torch.distributed` over gloo (`parallel.launch.spawn`,
one CPU thread each), and each rank runs the port on its block.  A few
spawns of four ranks (`tests/torch_mesh_ranks.py`) each run a suite of
checks, which the tests below read:

- halo pads on (1,2), (2,1) and (2,2) meshes equal the single-device pad's
  window bit for bit for every boundary kind, with halo_fuse on and off;
  a block smaller than the halo raises (RSL_LITE's min-patch-size rule);
- `overlap_stencil` equals pad-then-stencil, psum and pmax reduce over the
  mesh, `white_noise` of a block is the global field's window, the relax
  zone of specified boundaries and `gather` are exact;
- the warm bubble's dycore step (3 steps at 32x8x12) on (1,4) and (2,2)
  against the port on one block within `test_parallel.py`'s tolerances
  (bitwise on the CPU, which is reported), and against the JAX package's
  own sharded step on conftest's virtual devices within a few times the
  float32 noise between the two packages, which a test measures on one
  device (relative to each field's magnitude);
- the full ARC step (Morrison, RRTMG, CBM-Z with MOSAIC) on 2x2 against one
  block within `test_parallel.py`'s full-step tolerances, and in float64
  within 1e-10 relative;
- `Simulation(mesh=...)`: history, restart and auxhist files written from
  the same placed state on 2x2 and on 1x1 are byte-identical, a restart
  written on 2x2 continues on 1x1 bit for bit as the unbroken run, the
  tslist series is gathered, the NaN check raises on every rank; a rank
  that fails makes `spawn` raise without hanging.
"""

import filecmp
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)


from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore.solve import step as jstep  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHaloOps  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.sharded import (  # noqa: E402
    make_sharded_step as jmake_sharded_step,
)

from wrfchem_arc_interactions_tpu_torch.dycore import solve as tsolve  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid.grid import grid_from_numpy  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.io import history as hio  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.nest import NestedSimulation  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel import launch  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.sharded import halo_ops_for  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import (  # noqa: E402
    partition_spec, state_from_numpy, state_partition_specs,
)

import torch_mesh_ranks as R  # noqa: E402
from test_torch_slice import _jgrid_numpy  # noqa: E402

CPU4 = ["cpu"] * 4
# tests/test_parallel.py:56-57 and :165-169
TOL_DYCORE = {"u": 5e-3, "v": 5e-3, "w": 5e-3, "t": 5e-3, "mu": 0.1, "ph": 0.2, "qv": 1e-8}
TOL_FULL = {"u": 5e-3, "v": 5e-3, "w": 5e-3, "t": 5e-3, "mu": 0.1, "ph": 0.2,
            "qv": 1e-7, "qc": 1e-7, "nc": 5e2, "rthraten_sw": 1e-9, "rthraten_lw": 1e-9,
            "chem_so4_a01": 1e-4, "chem_num_a01": 5e3, "chem_o3": 1e-6, "chem_no2": 1e-6}
# The port against the JAX package on the warm bubble: max |a - b| over
# max |b|, per field.  Measured on the CPU, the port on one block against
# the JAX package on one device: after 1 step u 1.1e-3, v 8.7e-4, w 1.5e-3,
# t 2.0e-6, mu 1.0e-4, ph 1.5e-4; after 3 steps u 4.1e-3, v 6.2e-3,
# w 9.2e-4, t 3.9e-6, mu 2.9e-4, ph 2.9e-4 (u, v and w are perturbations of
# 0.07-0.5 m/s, and float32 noise of the full theta moves them by ~1e-3 of
# that in a step).  The port's (1,4) and (2,2) runs against the JAX
# package's sharded ones differ by no more (u 4.2e-3, v 5.8e-3 after 3
# steps); the JAX package's own (2,2) run against its one-device run by
# u 1.4e-3, v 2.9e-3.  The limits stand ~3x above the largest reading.  qv
# stays zero in this dry case: `test_parallel.py`'s absolute 1e-8.
NOISE_REL = {"u": 1.5e-2, "v": 2e-2, "w": 5e-3, "t": 1.5e-5, "mu": 1e-3, "ph": 1e-3}


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _within_noise(ref: dict, got: dict) -> dict:
    """The fields where `got` strays from `ref` past NOISE_REL (relative
    to the field's magnitude; qv absolute): {name: deviation}."""
    over = {}
    for name, lim in NOISE_REL.items():
        rel = _maxdiff(ref[name], got[name]) / float(np.abs(ref[name]).max())
        if not rel < lim:
            over[name] = rel
    if not _maxdiff(ref["qv"], got["qv"]) < TOL_DYCORE["qv"]:
        over["qv"] = _maxdiff(ref["qv"], got["qv"])
    return over


def _bitwise(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def halo():
    return launch.spawn(R.halo_suite, 4, "gloo", CPU4)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("bc", R.BCS)
@pytest.mark.parametrize("shape", R.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_halo_pad_matches_single_device(halo, shape, bc, fuse):
    """Every block's pad (widths 3 and 1; five fields of three shapes and
    two dtypes through `pad_many`) is the window of the single-device pad,
    bit for bit; fused, same-shaped fields share one message."""
    for rank_res in halo:
        ok, sent = rank_res[("pad", shape, bc, fuse)]
        assert ok
        assert sent > 0
    fused = halo[0][("pad", shape, bc, True)][1]
    unfused = halo[0][("pad", shape, bc, False)][1]
    assert fused < unfused


def test_block_smaller_than_halo_raises(halo):
    for rank_res in halo:
        assert rank_res["small"] is not None and "min-patch-size" in rank_res["small"]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("bc", ["periodic", "open"])
def test_overlap_stencil_matches_pad(halo, bc, overlap):
    """The overlapped schedule (bulk over local pads, four band recomputes
    from the true halos) equals pad-then-stencil on the whole domain: the
    reference allows 3e-5 relative for XLA's refusion; here the same
    operations run on the same values, and the result is bitwise."""
    for rank_res in halo:
        assert rank_res[("overlap", bc, overlap)] == 0.0


def test_psum_pmax(halo):
    for rank_res in halo:
        assert rank_res["psum"] == [10.0, -6.0]
        assert rank_res["pmax"] == [4.0, 0.0]


def test_white_noise_is_the_global_fields_window(halo):
    assert all(r["noise"] for r in halo)


def test_specified_relax_zone_on_blocks(halo):
    """The Davies zones on 2x2: the Laplacian of the deviation exchanges at
    seams and edge-replicates at the domain's edge only, bitwise as on one
    block (specified x, periodic y)."""
    assert all(r["relax"] for r in halo)


def test_polar_filter_on_blocks(halo):
    """On a (2, 1) mesh every block's row masks are the global ones (the v
    face below a block reads the row beneath through the exchange); a
    split x axis raises, as the reference's docstring requires."""
    assert all(r["polar"] for r in halo)
    from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
    from wrfchem_arc_interactions_tpu_torch.dycore.polar_filter import PolarFilter
    from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
    from wrfchem_arc_interactions_tpu_torch.parallel.mesh import Mesh
    hx = HaloOps(BCKind.PERIODIC, BCKind.OPEN,
                 mesh=Mesh(1, 2, 0, None, torch.device("cpu"), "gloo"))
    with pytest.raises(ValueError, match="mesh_x = 2"):
        PolarFilter(None, 45.0, 16, hx)


def test_gather(halo):
    assert halo[0]["gather"] is True
    assert all(r["gather"] is None for r in halo[1:])


def test_partition_specs():
    """z and band/bin/soil axes stay whole; y and x split."""
    specs = state_partition_specs(R.bubble_cfg())
    assert specs["u"] == (None, "my", "mx") and specs["mu"] == ("my", "mx")
    from wrfchem_arc_interactions_tpu_torch.registry.fields import FieldSpec
    assert partition_spec(FieldSpec("x", ("z", "y", "x"), extra=(("band", 4),))) == \
        (None, None, "my", "mx")
    hx = halo_ops_for(R.bubble_cfg(), make_mesh(1, 1, device="cpu"))
    assert not hx.sharded and hx.fuse


def test_place_cuts_by_partition_specs():
    """`place` cuts each state field by its field-table spec and each grid
    tensor by the grid's (the 1D vertical arrays whole); a state field the
    table does not hold raises."""
    from wrfchem_arc_interactions_tpu_torch.parallel.mesh import Mesh
    from wrfchem_arc_interactions_tpu_torch.parallel.sharded import place
    cfg = R.bubble_cfg()
    grid, state = R.bubble_case(cfg)
    mesh = Mesh(2, 2, 3, None, torch.device("cpu"), "gloo")
    blocks, g = place(state, grid, mesh, cfg)
    ys, xs = mesh.window(grid.ny, grid.nx)
    assert set(blocks) == set(state)
    for k, v in state.items():
        assert torch.equal(blocks[k], v[..., ys, xs]), k
    assert torch.equal(g.mub, grid.mub[ys, xs]) and torch.equal(g.rdnw, grid.rdnw)
    with pytest.raises(KeyError, match="not in the field table"):
        place({**state, "not_a_field": state["mu"]}, grid, mesh, cfg)


# -- the dycore ---------------------------------------------------------------


@pytest.fixture(scope="module")
def bubble():
    """The JAX package's warm bubble (tests/test_parallel.py::_case), the
    port's one-block run from it (3 steps), the port's mesh runs, JAX's
    sharded runs, and both packages on one device after 1 and 3 steps."""
    jc = jcfg.Config(domain=jcfg.DomainConfig(nx=32, ny=8, nz=12, dx=500.0, dy=500.0,
                                              ztop=10000.0, p_top=26000.0),
                     time_control=jcfg.TimeControl(dt=3.0))
    jg, js = jideal.make_case(jc, "warm_bubble", amplitude=2.0, zc=1500.0, xr=2500.0,
                              zr=1200.0, three_d=True)
    state_np = {k: np.asarray(v) for k, v in js.items()}
    grid_np = _jgrid_numpy(jg)
    meshes = launch.spawn(R.dycore_suite, 4, "gloo", CPU4, args=(state_np, grid_np))[0]
    cfg = R.bubble_cfg()
    hx = halo_ops_for(cfg, None)
    g, s = grid_from_numpy(grid_np, "cpu"), state_from_numpy(state_np, "cpu")
    jhx = JHaloOps(bc_x=jc.dynamics.bc_x, bc_y=jc.dynamics.bc_y)
    jone = jax.jit(lambda st: jstep(st, jg, jc, jhx, 3.0))
    j1 = js
    one_device = {}
    for n in range(1, 4):
        s, j1 = tsolve.step(s, g, cfg, hx, 3.0), jone(j1)
        if n in (1, 3):
            one_device[n] = ({k: v.numpy() for k, v in s.items()},
                             {k: np.asarray(v) for k, v in j1.items()})
    one = one_device[3][0]
    jax_runs = {}
    for shape in ((1, 4), (2, 2)):
        sstep, place = jmake_sharded_step(jc, jg, jmake_mesh(*shape), jstep, 3.0)
        s8, g8 = place(js, jg)
        for _ in range(3):
            s8 = sstep(s8, g8)
        jax_runs[shape] = {k: np.asarray(v) for k, v in s8.items()}
    return one, meshes, jax_runs, one_device


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_dycore_decomposition_invariance(bubble, shape):
    """The port on a mesh against the port on one block, within the
    reference's f32 tolerances; on the CPU every operation of the step is
    per cell or per column, so the runs agree bit for bit."""
    one, meshes, _, _ = bubble
    got = meshes[(shape, True)]
    for name, tol in TOL_DYCORE.items():
        assert _maxdiff(one[name], got[name]) < tol, name
    assert _bitwise(one, got)


def test_dycore_overlap_toggle(bubble):
    """overlap_halo off (blocking exchange, then one padded call) gives the
    overlapped schedule's results, bit for bit."""
    _, meshes, _, _ = bubble
    assert _bitwise(meshes[((2, 2), True)], meshes[((2, 2), False)])


@pytest.mark.parametrize("steps", [1, 3])
def test_dycore_noise_against_jax_one_device(bubble, steps):
    """The float32 noise between the packages, which bounds the mesh
    comparison below: the port on one block against the JAX package on one
    device, each field relative to its magnitude (NOISE_REL)."""
    port, ref = bubble[3][steps]
    assert _within_noise(ref, port) == {}


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_dycore_matches_jax_sharded_step(bubble, shape):
    """The port's mesh run against the JAX package's `make_sharded_step` on
    the same mesh (virtual CPU devices), from the same state, after 3
    steps: within a few times the packages' float32 noise on one device
    (NOISE_REL, relative to each field's magnitude)."""
    _, meshes, jax_runs, _ = bubble
    assert _within_noise(jax_runs[shape], meshes[(shape, True)]) == {}


# -- the full ARC step ----------------------------------------------------------


@pytest.fixture(scope="module")
def arc():
    meshes = launch.spawn(R.arc_suite, 4, "gloo", CPU4)[0]
    return meshes, R.run_arc(None, torch.float32, 2)


def test_full_step_decomposition_invariance(arc):
    """1 block vs 2x2 over the full ARC step (radiation and chemistry every
    step), f32, within the reference's tolerances (bitwise on the CPU)."""
    meshes, one = arc
    for name, tol in TOL_FULL.items():
        assert _maxdiff(one[name], meshes["f32"][name]) < tol, name
    assert _bitwise(one, meshes["f32"])
    assert meshes["exchanges"] > 0


def test_full_step_decomposition_invariance_f64(arc):
    """The float64 variant (8x8x8, one step): within 1e-10 relative."""
    meshes, _ = arc
    one = R.run_arc(None, torch.float64, 1)
    got = meshes["f64"]
    for name in ("u", "v", "w", "t", "mu", "ph", "qv", "qc", "rthraten_sw", "rthraten_lw",
                 "chem_so4_a01", "chem_o3"):
        assert got[name].dtype == np.float64
        scale = float(np.abs(one[name]).max()) + 1e-30
        assert _maxdiff(one[name], got[name]) / scale < 1e-10, name


# -- Simulation on a mesh -----------------------------------------------------------


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    """The simulation suite on 2x2, and the same on 1x1 in this process."""
    root = tmp_path_factory.mktemp("mesh_io")
    mesh_dir, one_dir = str(root / "2x2"), str(root / "1x1")
    res = launch.spawn(R.simulation_suite, 4, "gloo", CPU4, args=(mesh_dir,),
                       timeout_s=120.0)
    cfg = R.sim_cfg(6.0, ts=True)
    grid, state = R.bubble_case(cfg)
    sim = Simulation(cfg, grid, state, mesh=make_mesh(1, 1, device="cpu"),
                     output_dir=os.path.join(one_dir, "step0"))
    sim._write_output()
    sim.output_dir = os.path.join(one_dir, "run")
    sim.advance(2)
    hio.flush()
    return res, mesh_dir, one_dir, sim


@pytest.mark.parametrize("stream", ["hist", "restart", "auxdiag"])
def test_output_files_are_byte_identical(sims, stream):
    """A history, restart and auxhist file written from the same placed
    state (step 0) on 2x2 (gathered to rank 0) and on 1x1; and after 2
    steps."""
    _, mesh_dir, one_dir, _ = sims
    ext = hio.default_extension()
    for sub, n in (("step0", 0), ("run", 2)):
        name = f"{stream}_{n:06d}{ext}"
        a, b = os.path.join(mesh_dir, sub, name), os.path.join(one_dir, sub, name)
        assert os.path.exists(a) and os.path.exists(b)
        assert filecmp.cmp(a, b, shallow=False), name


def test_restart_crosses_decompositions(sims):
    """A restart written on 2x2 reads back into every rank's block, and
    read on 1x1 it continues bit for bit as the unbroken 1x1 run."""
    res, mesh_dir, _, one = sims
    for r in res:
        assert r["restart_read"] == (2, 6.0, True)
    cfg = R.sim_cfg()
    grid, state = R.bubble_case(cfg)
    path = os.path.join(mesh_dir, "run", f"restart_000002{hio.default_extension()}")
    back, step, t = hio.read_restart(path, cfg, state)
    resumed = Simulation(cfg, grid, back, device="cpu")
    resumed.step_idx, resumed.time_s = step, t
    resumed.advance(2)
    unbroken = Simulation(cfg, grid, state, device="cpu")
    unbroken.advance(4)
    for k in hio.restart_names(cfg):
        assert torch.equal(resumed.state[k], unbroken.state[k]), k
    assert _bitwise(res[0]["state"], {k: v.numpy() for k, v in one.state.items()})


def test_tslist_is_gathered(sims):
    """Points on three different blocks, recorded by their owners, gathered
    on every rank (rank 0 writes them): the 1x1 series."""
    res, _, _, one = sims
    for r in res:
        assert r["ts"] == one.ts_series
    assert all(len(rows) == 2 for rows in one.ts_series.values())


def test_check_nans_raises_on_every_rank(sims):
    res, _, _, _ = sims
    for r in res:
        assert r["nan"] is not None and "NaN in theta" in r["nan"]


def test_nest_on_a_mesh_raises():
    """Sharded nests come with ROADMAP Queue 1 item 10b."""
    cfg = R.bubble_cfg()
    grid, state = R.bubble_case(cfg)
    with pytest.raises(NotImplementedError, match="item 10b"):
        NestedSimulation(cfg, grid, state, None, None, mesh=make_mesh(1, 1, device="cpu"),
                         device="cpu")


# -- the process setup ---------------------------------------------------------------


def test_spawn_raises_when_a_rank_fails():
    """Rank 1 raises while rank 0 waits on it: `spawn` raises with rank 1's
    traceback and stops rank 0, well inside the group's timeout."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.spawn(R.spawn_failure, 2, "gloo", ["cpu"] * 2, timeout_s=60.0)


def test_mesh_refusals():
    """A mesh whose size is not the group's, and a domain the mesh does not
    split evenly (the reference's `block_shape` error), raise; so does a
    mesh of several blocks without a process group."""
    out = launch.spawn(R.mesh_errors, 2, "gloo", ["cpu"] * 2)
    for r in out:
        assert "needs 4 ranks, the group has 2" in r[(2, 2)]
        assert "needs 3 ranks" in r[(1, 3)]
        assert "not divisible by mesh (1,2)" in r["uneven"]
    with pytest.raises(ValueError, match="process"):
        make_mesh(2, 2, device="cpu")
