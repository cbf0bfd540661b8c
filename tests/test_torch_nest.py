"""The port's nests (`models/nest.py`) and ndown (`models/ndown.py`)
against the JAX package: the interpolation matrices bit for bit, the
parent-to-child interpolation, one-way and two-way nested runs, a moving
nest, and ndown from history files written by either package; then the
reference's own properties on the port (exact moves, feedback equal to the
child's block average, a window that follows the updraft).  Mirrors the
reference's tests/test_nest.py and test_ndown.py.

Tolerances: the matrices are numpy in both packages and equal bit for
bit.  The interpolation is a float32 einsum in both (the sums in another
order): 1e-6 of the field's magnitude.  A nested run is held as the slice
test holds a run (tests/test_torch_slice.py): per field 1e-4 of its
magnitude (phi at that of phb), or three times the run's own float32 noise
where that is larger.  The noise is measured on the port (its run again
from the full theta changed by one ulp), which costs no second compile of
the reference's two steppers.
"""

import glob

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.io import history as jhio  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ndown as jndown  # noqa: E402
from wrfchem_arc_interactions_tpu.models import nest as jnest  # noqa: E402
from wrfchem_arc_interactions_tpu.models import soundings as jsnd  # noqa: E402
from wrfchem_arc_interactions_tpu.models.driver import Simulation as JSim  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.io import history as thio  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ndown as tndown  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import nest as tnest  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import soundings as tsnd  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402

from test_torch_slice import jax_grid_to_port  # noqa: E402

SPEC = dict(i_start=8, j_start=3, nx_parent_cells=8, ny_parent_cells=8, ratio=3)
BUBBLE = dict(amplitude=2.0, zc=1500.0, xr=6000.0, zr=1200.0, three_d=True)
FIELDS = ("u", "v", "w", "t", "mu", "ph")


def _cfgs(nx=24, ny=14, nz=8, history_s=0.0):
    return [m.Config(domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=3000.0, dy=3000.0,
                                           ztop=12000.0, p_top=20000.0),
                     time_control=m.TimeControl(dt=12.0, history_interval_s=history_s),
                     dynamics=m.DynamicsConfig(kvdif=20.0))
            for m in (jcfg, tcfg)]


@pytest.mark.parametrize("stagger", [False, True])
def test_interp_matrices_and_field_match_jax(stagger):
    """The 1D matrices bit for bit (a start at the parent's edge clamps);
    ParentToChild on a 3D field of each staggering to 1e-6; and it is
    exact on linear fields away from the clamped edges."""
    for n, start, nc, r in ((24, 8, 24, 3), (14, 0, 18, 3), (10, 7, 15, 5)):
        a = jnest._interp_matrix(n, start, nc, r, stagger)
        b = tnest._interp_matrix(n, start, nc, r, stagger)
        assert b.dtype == np.float32 and np.array_equal(a, b)
    rng = np.random.default_rng(1)
    field = rng.normal(300.0, 5.0, (5, 14, 24)).astype(np.float32)
    ji = jnest.ParentToChild(jnest.NestSpec(**SPEC), 14, 24)
    ti = tnest.ParentToChild(tnest.NestSpec(**SPEC), 14, 24)
    for name in ("t", "u", "v"):
        a = np.asarray(ji.field(jnp.asarray(field), name))
        b = ti.field(torch.from_numpy(field), name).numpy()
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max(), name
    yy, xx = np.meshgrid(np.arange(14.0), np.arange(24.0), indexing="ij")
    lin = torch.from_numpy((2.0 * (xx + 0.5) - 3.0 * (yy + 0.5) + 7.0).astype(np.float32))
    got = ti.field(lin, "t").numpy()
    cj, ci = np.meshgrid(np.arange(24), np.arange(24), indexing="ij")
    want = 2.0 * (8 + (ci + 0.5) / 3) - 3.0 * (3 + (cj + 0.5) / 3) + 7.0
    np.testing.assert_allclose(got[2:-2, 2:-2], want[2:-2, 2:-2], rtol=0, atol=1e-4)


def _nested_runs(feedback, steps, move=None):
    """(jax nest, port nest, port nest from the full theta + one ulp) after
    `steps` parent steps of a 3D warm bubble; with `move`, the window moved
    by it after the first step."""
    jc, tc = _cfgs()
    jg, js = jideal.make_case(jc, "warm_bubble", **BUBBLE)
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy({k: np.asarray(v) for k, v in js.items()}, "cpu")
    ts_ulp = dict(ts, t=(ts["t"] + 300.0) * (1.0 + 2.0 ** -23) - 300.0)
    nests = [jnest.NestedSimulation(jc, jg, js, jnest.NestSpec(**SPEC),
                                    theta_of_z=jsnd.constant_n2_theta(), feedback=feedback)]
    nests += [tnest.NestedSimulation(tc, tg, s, tnest.NestSpec(**SPEC),
                                     theta_of_z=tsnd.constant_n2_theta(), feedback=feedback,
                                     device="cpu") for s in (ts, ts_ulp)]
    for n in nests:
        n.advance(1)
        if move is not None:
            n.move(*move)
        n.advance(steps - 1)
    return nests


def _assert_close(nests, label):
    for which in ("parent", "child"):
        a, b, b_ulp = (getattr(n, which) for n in nests)
        phb = float(np.abs(np.asarray(a.grid.phb)).max())
        for k in FIELDS:
            ref = np.asarray(a.state[k], np.float64)
            scale = phb if k == "ph" else max(float(np.abs(ref).max()), 1e-30)
            err = float(np.abs(b.state[k].numpy() - ref).max()) / scale
            noise = float((b_ulp.state[k] - b.state[k]).abs().max()) / scale
            assert err <= max(1e-4, 3.0 * noise), (label, which, k, err, noise)
    assert float(nests[1].child.state["w"].abs().max()) > 1e-3


def test_one_way_nest_parent_is_a_plain_run():
    """One-way: the parent of a nest steps exactly as a Simulation alone,
    and the child's spec ring is the parent's state interpolated to it,
    bracketed over the parent step (the boundary the child last stepped
    with, at the child's last step start)."""
    _, tc = _cfgs()
    grid, state = tideal.make_case(tc, "warm_bubble", device="cpu", **BUBBLE)
    nest = tnest.NestedSimulation(tc, grid, state, tnest.NestSpec(**SPEC),
                                  theta_of_z=tsnd.constant_n2_theta(), device="cpu")
    alone = TSim(tc, grid, state, device="cpu")
    nest.advance(2)
    alone.advance(2)
    assert all(torch.equal(nest.parent.state[k], alone.state[k]) for k in alone.state)
    child = nest.child
    t_last = np.float32(child.time_s - child.dt)
    ring = child.boundary.at_time(t_last)
    for k in FIELDS:
        assert torch.equal(child.state[k][..., 0, :], ring[k][..., 0, :]), k
        assert torch.equal(child.state[k][..., :, -1], ring[k][..., :, -1]), k
    assert float(child.state["w"].abs().max()) > 1e-3


def test_two_way_nest_with_move_matches_jax():
    """A two-way nest moved one parent cell east after its first step, two
    parent steps in all (six child steps, the boundary bracketed on each
    parent step), against the reference; and the port's feedback leaves
    the overlapped parent interior equal to the child's block average (the
    reference's property)."""
    nests = _nested_runs(True, 2, move=(1, 0))
    _assert_close(nests, "two-way")
    t = nests[1]
    s, r = t.spec, 3
    assert s.i_start == SPEC["i_start"] + 1
    a = t.child.state["t"]
    blk = a.reshape(a.shape[0], s.ny_parent_cells, r, s.nx_parent_cells, r).mean((2, 4))
    dyn = t.cfg_child.dynamics
    skip_p = -(-(dyn.spec_zone + dyn.relax_zone) // r) + 1
    sub = blk[:, skip_p:s.ny_parent_cells - skip_p, skip_p:s.nx_parent_cells - skip_p]
    p = t.parent.state["t"][:, s.j_start + skip_p:s.j_start + s.ny_parent_cells - skip_p,
                            s.i_start + skip_p:s.i_start + s.nx_parent_cells - skip_p]
    assert p.numel() > 0 and float((p - sub).abs().max()) <= 1e-5


def test_moving_nest_shift_is_exact_and_follows_updraft():
    """move(1, 0) rolls the surviving child content by one parent cell of
    child cells exactly; follow_max_w moves the window toward a bubble east
    of its centre (the reference's properties, on the port)."""
    _, tc = _cfgs(nx=32, ny=12, nz=8)
    grid, state = tideal.make_case(tc, "warm_bubble", device="cpu",
                                   **dict(BUBBLE, amplitude=3.0, xc_frac=0.7))
    nest = tnest.NestedSimulation(tc, grid, state,
                                  tnest.NestSpec(i_start=6, j_start=3, nx_parent_cells=8,
                                                 ny_parent_cells=6, ratio=3),
                                  theta_of_z=tsnd.constant_n2_theta(), device="cpu")
    nest.advance(1)
    before = nest.child.state["t"].clone()
    nest.move(1, 0)
    assert torch.equal(nest.child.state["t"][:, :, :-3], before[:, :, 3:])
    i0 = nest.spec.i_start
    for _ in range(4):
        nest.advance(1)
        nest.follow_max_w()
    assert nest.spec.i_start > i0
    assert torch.isfinite(nest.child.state["w"]).all()


def _coarse_histories(tmp_path):
    """History files of a 60 s coarse run (one every 24 s), written by each
    package from the same start: {package: [paths]}."""
    jc, tc = _cfgs(nx=24, ny=12, nz=8, history_s=24.0)
    jg, js = jideal.make_case(jc, "warm_bubble", **dict(BUBBLE, xr=8000.0))
    out = {}
    for key in ("jax", "torch"):
        d = tmp_path / key
        d.mkdir()
        if key == "jax":
            JSim(jc, jg, js, output_dir=str(d)).advance(4)
            jhio.flush()
        else:
            ts = state_from_numpy({k: np.asarray(v) for k, v in js.items()}, "cpu")
            TSim(tc, jax_grid_to_port(jg), ts, output_dir=str(d), device="cpu").advance(4)
            thio.flush()
        out[key] = sorted(glob.glob(str(d / "hist_*")))
        assert len(out[key]) == 2
    return jc, tc, out


def test_ndown_matches_jax_and_runs(tmp_path):
    """ndown from the port's files against the reference's ndown from the
    same files, and the port's ndown from the reference's files: the child
    grid bit for bit, the initial state and the segments to 1e-6 (float32
    einsum); then the fine domain runs through the segment swap."""
    jc, tc, files = _coarse_histories(tmp_path)
    spec = dict(i_start=8, j_start=3, nx_parent_cells=8, ny_parent_cells=6, ratio=3)
    for key in ("torch", "jax"):
        jr = jndown.ndown(jc, files[key], jnest.NestSpec(**spec), jsnd.constant_n2_theta())
        tr = tndown.ndown(tc, files[key], tnest.NestSpec(**spec), tsnd.constant_n2_theta(),
                          device="cpu")
        assert tr[0].domain.nx == 24 and tr[0].time_control.dt == 4.0
        for name in ("mub", "phb", "znw"):
            assert np.array_equal(np.asarray(getattr(jr[1], name)),
                                  getattr(tr[1], name).numpy())
        assert len(tr[3]) == len(jr[3]) == 1
        pairs = [(jr[2][k], tr[2][k]) for k in tndown.FORCED_DEFAULT]
        pairs += [(getattr(jr[3][0], s)[k], getattr(tr[3][0], s)[k])
                  for s in ("lo", "hi") for k in tndown.FORCED_DEFAULT]
        for a, b in pairs:
            a = np.asarray(a)
            assert np.abs(a - b.numpy()).max() <= 1e-6 * max(np.abs(a).max(), 1e-3)
        assert (float(jr[3][0].t_lo), float(jr[3][0].t_hi)) == (tr[3][0].t_lo, tr[3][0].t_hi)
    cfg_c, grid_c, state0, segs = tr
    assert float(state0["t"].abs().max()) > 0.05
    fine = TSim(cfg_c, grid_c, state0, boundary=segs[0], check_nans=True, device="cpu")
    fine.advance(3)
    fine.boundary = tnest.LateralBoundary(lo=segs[0].hi, hi=segs[0].hi, t_lo=segs[0].t_hi,
                                          t_hi=segs[0].t_hi + 1.0)
    fine.advance(3)
    assert float(fine.state["w"].abs().max()) < 10.0
