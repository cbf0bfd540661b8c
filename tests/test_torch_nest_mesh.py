"""Nests on a process mesh, on the CPU: `NestedSimulation(..., mesh=...)`
with parent and child on a 2x2 mesh of gloo ranks (`parallel.launch.spawn`,
the rank programs in `torch_mesh_ranks.py`, which import the port only).

Mirrors the reference's slow-marked
``tests/test_nest.py::test_sharded_child_matches_single_device``: the 3D
warm bubble at 24x8x12 with ``NestSpec(8, 2, 8, 4, 3)``, 3 parent steps.
The cases:

- one-way;
- two-way, in a window whose feedback cells straddle both seams (the
  reference's window feeds back no parent cell: 4 rows less 3 skipped on
  each side);
- a window moved one parent cell east, then `follow_max_w` toward an
  updraft that lies on rank 1 or 3, never on rank 0;
- config 4 nested at a small size (Morrison, RRTMG, CBM-Z with MOSAIC
  4-bin; 16x16x10 parent, 24x24 child, two-way, 2 parent steps with
  chemistry and radiation on every parent step), float32, which runs the
  child's ARC step and its specified edges at the seams of its blocks;
- a child that the mesh does not split evenly, refused on every rank.

Gathered, parent and child equal the port's one-block nested run bit for
bit in every state field.  The three warm-bubble cases are also held to the
JAX package's one-device `NestedSimulation` within the reference test's own
limits: 5e-3 for u, v, w and t, 0.5 for mu and ph.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.models import nest as jnest  # noqa: E402
from wrfchem_arc_interactions_tpu.models import soundings as jsnd  # noqa: E402

from wrfchem_arc_interactions_tpu_torch.parallel import launch  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from test_torch_slice import _jgrid_numpy  # noqa: E402

CPU4 = ["cpu"] * 4
BUBBLE = dict(amplitude=2.0, zc=1500.0, xr=6000.0, zr=1200.0, three_d=True)
# tests/test_nest.py:139-141
TOL_JAX = {"u": 5e-3, "v": 5e-3, "w": 5e-3, "t": 5e-3, "mu": 0.5, "ph": 0.5}
# name: (NestSpec, feedback, the bubble's x centre as a fraction of the domain)
BUBBLE_CASES = {"one_way": (R.NEST_SPEC, False, 0.5),
                "two_way": (R.FEEDBACK_SPEC, True, 0.5),
                "moving": (R.NEST_SPEC, True, 0.75)}


def _jax_run(name, jc, jg, js, spec, feedback):
    """The JAX package's one-device nest, stepped as `R.nested_runs` steps
    the port's; (parent, child) states as numpy."""
    nest = jnest.NestedSimulation(jc, jg, js, jnest.NestSpec(**spec),
                                  theta_of_z=jsnd.constant_n2_theta(), feedback=feedback)
    if name == "moving":
        nest.advance(1)
        nest.move(1, 0)
        nest.advance(1)
        nest.follow_max_w()
        nest.advance(1)
    else:
        nest.advance(3)
    return tuple({k: np.asarray(v) for k, v in sim.state.items()}
                 for sim in (nest.parent, nest.child))


@pytest.fixture(scope="module")
def nests():
    """(JAX runs, the port's one-block runs and follow, the 4 ranks'
    results) from the same global inputs."""
    c = R.nest_cfg().domain
    jc = jcfg.Config(domain=jcfg.DomainConfig(nx=c.nx, ny=c.ny, nz=c.nz, dx=c.dx, dy=c.dy,
                                              ztop=c.ztop, p_top=c.p_top),
                     time_control=jcfg.TimeControl(dt=R.nest_cfg().time_control.dt),
                     dynamics=jcfg.DynamicsConfig(kvdif=R.nest_cfg().dynamics.kvdif))
    cases, jax_runs = {}, {}
    for name, (spec, feedback, xc_frac) in BUBBLE_CASES.items():
        jg, js = jideal.make_case(jc, "warm_bubble", xc_frac=xc_frac, **BUBBLE)
        cases[name] = {"state": {k: np.asarray(v) for k, v in js.items()},
                       "grid": _jgrid_numpy(jg), "spec": spec, "feedback": feedback}
        jax_runs[name] = _jax_run(name, jc, jg, js, spec, feedback)
    cases["config4"] = None
    one, follow = R.nested_runs(None, cases)
    ranks = launch.spawn(R.nest_suite, 4, "gloo", CPU4, args=(cases,))
    return jax_runs, one, follow, ranks


@pytest.mark.parametrize("case", ["one_way", "two_way", "moving", "config4"])
def test_nest_on_a_mesh_is_bitwise(nests, case):
    """Gathered from the 2x2 mesh, parent and child equal the one-block
    nested run bit for bit in every state field, the window in the same
    place."""
    _, one, _, ranks = nests
    got = ranks[0]["runs"][case]
    assert got[2] == one[case][2]
    for which in (0, 1):
        want = one[case][which]
        assert set(got[which]) == set(want)
        for k, v in want.items():
            assert np.isfinite(v).all(), (case, which, k)
            assert np.array_equal(got[which][k], v), (case, which, k,
                                                      float(np.abs(got[which][k] - v).max()))
    assert all(r["runs"][case] is None for r in ranks[1:])


@pytest.mark.parametrize("case", list(BUBBLE_CASES))
def test_nest_on_a_mesh_matches_jax(nests, case):
    """The gathered 2x2 nest against the JAX package's one-device nest
    within the reference's limits (tests/test_nest.py:139-143)."""
    jax_runs, _, _, ranks = nests
    for which, label in ((0, "parent"), (1, "child")):
        for k, tol in TOL_JAX.items():
            d = float(np.abs(ranks[0]["runs"][case][which][k].astype(np.float64)
                             - jax_runs[case][which][k]).max())
            assert d < tol, (case, label, k, d)
    assert float(np.abs(ranks[0]["runs"][case][1]["w"]).max()) > 1e-3


def test_follow_max_w_agrees_on_every_rank(nests):
    """The strongest column lies off rank 0's block; every rank takes the
    one-block run's move toward it, one parent cell east."""
    _, _, follow, ranks = nests
    (j, i), move = follow
    by, bx = R.nest_cfg().domain.ny // 2, R.nest_cfg().domain.nx // 2
    assert (j // by) * 2 + i // bx != 0
    assert move == (1, 0)
    assert ranks[0]["follow"][0] == (j, i)
    assert all(r["follow"][1] == move for r in ranks)


def test_nest_gathers_are_counted(nests):
    """The nest's all-gathers are counted on the mesh, apart from the
    halo's exchanges: the same number on every rank."""
    ranks = nests[3]
    assert len({(r["all_gathers"], r["all_gather_bytes"]) for r in ranks}) == 1
    assert ranks[0]["all_gathers"] > 0 and ranks[0]["all_gather_bytes"] > 0


def test_uneven_child_is_refused_on_every_rank(nests):
    """A 9-row child on a 2x2 mesh: every rank raises before any collective
    (a rank that raised alone would leave the others in a gather)."""
    for r in nests[3]:
        assert r["uneven"] is not None
        assert "child domain" in r["uneven"] and "not divisible by mesh (2,2)" in r["uneven"]
