"""Cells of several cards on the CPU: four gloo ranks through
`parallel.launch.spawn`, each a 2x2 mesh's block of arc_block's package at
16x16x12, through the entry that `port_bench.run` uses for the cards; the
check in ringed tiles (`port_bench.tiles`) against the whole-domain
follow; the faults the tiled check has to catch."""

import copy
import functools
import json
import shutil
import time

import pytest
import torch
import torch.distributed as dist

from port_bench import check, harness, run, spec, tiles

torch.set_num_threads(1)

SHAPE = {"nx": 16, "ny": 16, "nz": 12}
SEED = 2**31 + 11
CPU4 = ["cpu"] * 4
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _mesh_cell(bench, here=spec.HERE, name="arc_block.main", chips=4, mesh=(2, 2)):
    """arc_block.main's cell on a mesh_y x mesh_x mesh at SHAPE."""
    cell = copy.deepcopy(spec.workload(bench, name, here=here))
    cell["name"], cell["chips"] = "arc_mesh.main", chips
    cell["config_spec"]["namelist"]["domain"].update(SHAPE)
    cell["config_spec"]["namelist"]["parallel"] = {"mesh_y": mesh[0], "mesh_x": mesh[1]}
    return cell


def _short(cell):
    """The cell with periods of 2 steps, both of them followed by the check
    (no chem call in them): the faults' runs."""
    cell["traffic"] = dict(cell["traffic"], period_steps=2)
    return cell


def _measure(cell, **kw):
    return harness.measure(cell, spec.benchmark(), SEED, 0.0, False, CPU4,
                           time.perf_counter(), **kw)


def test_a_four_card_cell_is_added_by_files_and_runs_through_the_entry(tmp_path, monkeypatch,
                                                                       capsys):
    """A cell of 4 chips and a 2x2 `parallel` namelist, added to a copy of
    the files as data alone, runs through `run.execute` (what `run.main`
    calls for the cards) on four gloo ranks: correct, bit for bit the
    reference, the one-card line's keys; the bfloat16 control in the port's
    place is not correct."""
    here = tmp_path / "port_bench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.load(open(here / "configs" / "arc_block.json"))
    cfg["namelist"]["domain"].update(SHAPE)
    cfg["namelist"]["parallel"] = {"mesh_x": 2, "mesh_y": 2}
    json.dump(cfg, open(here / "configs" / "arc_mesh.json", "w"))
    shutil.copy(here / "limits" / "arc_block.main.json", here / "limits" / "arc_mesh.main.json")
    bench = spec.benchmark()
    bench["configs"].append(dict(bench["configs"][0], name="arc_mesh",
                                 file="port_bench/configs/arc_mesh.json"))
    bench["workloads"].append({"name": "arc_mesh.main", "config": "arc_mesh",
                               "traffic": "alarm_periods", "chips": 4, "why": "test"})
    cell = spec.workload(bench, "arc_mesh.main", here=str(here))
    assert spec.mesh_shape(cell) == (2, 2)

    seen = {}
    monkeypatch.setattr(harness, "measure",
                        functools.partial(harness.measure, precisions=("bfloat16",)))
    monkeypatch.setattr(harness, "report", lambda records, numbers: seen.update(
        records=records, numbers=numbers))
    assert run.execute(cell, bench, SEED, 0.0, False, CPU4, time.perf_counter()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == LINE_KEYS
    assert line["correct"] is True and line["attempted"] == 10 and line["failed"] == 0
    assert set(line["metrics"]) == {"gridpoints_per_s", "setup_s"}   # no card: no peak
    assert line["device"]["count"] == 4
    numbers, records = seen["numbers"], seen["records"]
    assert numbers["start_err"] == 0.0 and numbers["state_err"] == 0.0
    assert numbers["tiles"] == 4 and numbers["ring"] == tiles.RING
    # the global shape, so that the readers count every card's points
    assert records["shape"] == [16, 16, 12] and len(records["ranks"]) == 4
    assert numbers["control.bfloat16.correct"] is False
    assert numbers["control.bfloat16.state_err"] > line["checks"]["state_err"]["limit"]


# faults, planted in the ranks by `rank_init` (module-level, so that the
# spawned ranks find them by name)

def _stale_rank_1(rank):
    """Rank 1's main step runs, exchanges and all, and returns its input."""
    if rank != 1:
        return
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    orig = Simulation._stepper

    def stepper(self, key):
        fn = orig(self, key)
        if key != "main":
            return fn

        def main(s, g, t):
            fn(s, g, t)
            return s
        return main

    Simulation._stepper = stepper


def _altered_on_rank_3(rank):
    """One value of rank 3's theta altered after every main step."""
    if rank != 3:
        return
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    orig = Simulation._stepper

    def stepper(self, key):
        fn = orig(self, key)
        if key != "main":
            return fn

        def main(s, g, t):
            out = dict(fn(s, g, t))
            out["t"] = out["t"].clone()
            out["t"][3, 4, 5] += 0.5
            return out
        return main

    Simulation._stepper = stepper


def _blocks_1_2_swapped(rank):
    """Ranks 1 and 2 hand in each other's final block."""
    if rank not in (1, 2):
        return
    orig = harness._final_state

    def swapped(sim):
        mine = orig(sim)
        other = {k: torch.empty_like(v) for k, v in mine.items()}
        peer = 3 - rank
        for k in sorted(mine):
            if rank == 1:
                dist.send(mine[k], peer)
                dist.recv(other[k], peer)
            else:
                dist.recv(other[k], peer)
                dist.send(mine[k], peer)
        return other

    harness._final_state = swapped


def _raises_on_rank_2(rank):
    if rank == 2:
        raise RuntimeError("rank 2 fails on purpose")


@pytest.mark.parametrize("fault", [_stale_rank_1, _altered_on_rank_3, _blocks_1_2_swapped])
def test_a_fault_on_one_rank_is_not_correct(fault):
    cell = _short(_mesh_cell(spec.benchmark()))
    res = _measure(cell, rank_init=fault)
    assert res["correct"] is False
    assert res["numbers"]["state_err"] > res["checks"]["state_err"]["limit"]


def test_a_rank_that_raises_ends_the_run_with_no_line(capsys):
    cell = _short(_mesh_cell(spec.benchmark()))
    with pytest.raises(RuntimeError, match="rank 2 fails on purpose"):
        run.execute(cell, spec.benchmark(), SEED, 0.0, False, CPU4, time.perf_counter(),
                    rank_init=_raises_on_rank_2)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("chips, mesh", [(4, None), (4, (1, 2)), (2, (2, 2)), (1, (1, 2))])
def test_a_mesh_that_is_not_the_cells_chips_is_refused(monkeypatch, capsys, chips, mesh):
    bench = spec.benchmark()
    cell = _mesh_cell(bench, chips=chips, mesh=mesh or (1, 1))
    if mesh is None:
        del cell["config_spec"]["namelist"]["parallel"]
    with pytest.raises(ValueError, match="one block a card"):
        spec.mesh_shape(cell)
    monkeypatch.setattr(spec, "workload", lambda bench_, name: cell)
    code = run.main(["--workload", cell["name"], "--seed", "1", "--seconds", "1"])
    err = capsys.readouterr()
    assert code == 2 and err.out == "" and "one block a card" in err.err


def _reference_case(n):
    from port_bench import case
    from port_bench.reference.runner import Model
    from port_bench.reference.wrf.config import namelist
    cell = spec.workload(spec.benchmark(), "arc_block.main")
    cs = cell["config_spec"]
    cs["namelist"]["domain"].update(nx=n, ny=n, nz=SHAPE["nz"])
    model = Model(case.build_config(namelist, cs))
    grid, state = model.case(cs["case"], "cpu", **cs["case_args"])
    return model, grid, case.seeded_state(state, cs, cell["traffic"], SEED)


def test_the_ring_holds_the_reach_of_the_followed_steps():
    """The reach of arc_block's 2 followed steps (10 and 11, the chem call's
    step among them), measured at 40x40: a change in one column moves cells
    as far as this, and no farther; the ring is wider."""
    model, grid, state = _reference_case(40)
    far = tiles.reach(model, grid, state, 10, 2, [(20, 20), (6, 33)])
    assert 8 <= far <= tiles.RING, far


def _tiled_rank(rank, device, ring):
    """One of four gloo ranks: its 8x8 block of a 16x16 domain extended
    by `ring` from the others' (`tiles.extend`), followed through steps
    10 and 11 and held to the reference's follow of the whole domain."""
    torch.set_num_threads(1)
    model, grid, state = _reference_case(16)
    whole = dict(state)
    for n in (10, 11):
        whole = model.step(whole, grid, n)
    iy, ix = divmod(rank, 2)
    ys, xs = slice(8 * iy, 8 * iy + 8), slice(8 * ix, 8 * ix + 8)
    block = {k: v[..., ys, xs].contiguous() for k, v in state.items()}
    ext = tiles.extend(block, (2, 2), rank, ring)
    final = {k: v[..., ys, xs] for k, v in whole.items()}
    return tiles.follow(model, grid, ext, (ys.start, xs.start), tiles.plan(8, 8, ring), ring,
                        10, 2, final, torch.device("cpu"))


@pytest.mark.parametrize("ring, bitwise", [(tiles.RING, True), (1, False)])
def test_ringed_tiles_follow_as_the_whole_domain_does(ring, bitwise):
    """The reference over each rank's block of a 2x2 mesh on a 16x16
    domain, ringed from the other ranks across the periodic edges, is the
    reference over the whole domain bit for bit at the harness's ring, and
    is not at a ring of 1."""
    from wrfchem_arc_interactions_tpu_torch.parallel import launch
    parts = launch.spawn(_tiled_rank, 4, "gloo", CPU4, args=(ring,))
    maxima = check.merge_maxima(p["state"] for p in parts)
    errs = check.errs_from_maxima(maxima)
    assert len(errs) == 126
    if bitwise:
        assert all(equal for *_, equal, _ in maxima.values())
        assert max(errs.values()) == 0.0
    else:
        assert max(errs.values()) > 0.0


class _Stencil:
    """A model whose step averages each field over its 5-point cross on the
    (periodic) domain it is given and adds the grid's mub: a reach of one
    cell a step."""
    precision = "stencil"

    def step(self, s, g, n):
        out = {}
        for k, v in s.items():
            cross = v + v.roll(1, -1) + v.roll(-1, -1) + v.roll(1, -2) + v.roll(-1, -2)
            out[k] = cross / 5 + g.mub * (1e-3 * (n + 1))
        return out


@pytest.mark.parametrize("ring, bitwise", [(2, True), (1, False)])
def test_tiles_within_a_block_are_cut_and_put_back_in_place(ring, bitwise):
    """Several tiles a block, at offsets in y and x and across the wrap,
    each with its grid cut from the global one: a stencil of one cell a
    step, followed 2 steps in tiles, is its whole-domain follow bit for bit
    at a ring of 2, and is not at 1 (its control, the same stencil, equal)."""
    import dataclasses
    _, grid, _ = _reference_case(16)
    g = torch.Generator().manual_seed(3)
    grid = dataclasses.replace(grid, mub=torch.rand(16, 16, generator=g))
    state = {"a": torch.rand(3, 16, 16, generator=g), "b": torch.rand(16, 16, generator=g)}
    model = _Stencil()
    whole = dict(state)
    for n in (4, 5):
        whole = model.step(whole, grid, n)
    ext = tiles.extend(state, (1, 1), 0, ring)
    plan = tiles.plan(16, 16, ring, max_columns=(8 + 2 * ring) ** 2)
    assert plan == [(0, 8, 0, 8), (0, 8, 8, 16), (8, 16, 0, 8), (8, 16, 8, 16)]
    out = tiles.follow(model, grid, ext, (0, 0), plan, ring, 4, 2, whole,
                       torch.device("cpu"), controls=[model])
    assert check.errs_from_maxima(out["stencil"]) == {"a": 0.0, "b": 0.0}
    equal = all(m[2] for m in out["state"].values())
    assert equal is bitwise


def test_the_tiles_maxima_join_into_the_whole_domains_errors():
    """Per field, the maxima of pieces joined, then divided, give what
    `field_errs` gives over the whole: also where one piece is equal and
    holds the largest magnitude, and where a value is not finite."""
    g = torch.Generator().manual_seed(5)
    ref = {"a": torch.rand(3, 6, 8, generator=g), "b": torch.rand(6, 8, generator=g) * 100}
    port = {k: v.clone() for k, v in ref.items()}
    port["a"][1, 4, 6] += 1e-3
    port["b"][0, 1] = float("nan")
    # an infinite value where both sides agree, and a difference elsewhere
    ref["c"] = torch.rand(6, 8, generator=g)
    ref["c"][0, 0] = float("inf")
    port["c"] = ref["c"].clone()
    port["c"][5, 7] += 1.0
    pieces = [(slice(0, 3), slice(0, 8)), (slice(3, 6), slice(0, 4)), (slice(3, 6), slice(4, 8))]
    parts = [check.field_maxima({k: v[..., ys, xs] for k, v in port.items()},
                                {k: v[..., ys, xs] for k, v in ref.items()}, "cpu")
             for ys, xs in pieces]
    joined = check.errs_from_maxima(check.merge_maxima(parts))
    assert joined == check.field_errs(port, ref, "cpu")
    assert joined["b"] == joined["c"] == float("inf") and 0.0 < joined["a"] < 2e-3


def test_traced_parts_join_into_card_seconds():
    """With --trace 1, the ranks' parts join: busy and window seconds, and
    each kernel's, summed over the cards, so that the readers' counts of
    the global shape read a share of all four cards; `device` gives their
    means; the peak is the fullest card's; launches and breakdown rank 0's."""
    from port_bench import counts
    bench = spec.benchmark()
    cell = _mesh_cell(bench, name="arc_block.main")
    cell["name"] = "arc_block.main"          # the cell the per-layer metrics name
    busy, wall, k4 = [0.9, 0.8, 0.85, 0.95], [1.0, 1.01, 0.99, 1.0], [0.2, 0.25, 0.22, 0.21]
    main = [0.5, 0.52, 0.49, 0.51]
    parts = []
    for r in range(4):
        trace = {"window_s": wall[r], "busy_s": busy[r], "launches": 1000 + r,
                 "kernels": {"limited_kernel": (3, k4[r])}, "device_ops": [[f"op{r}", 0.1]],
                 "idle_gaps": [[f"gap{r}", 0.01]], "steps": 10, "chem_calls": 1,
                 "rad_calls": 0}
        records = {"cell": cell["name"], "shape": [16, 16, 12], "scalars": 107, "bins": 4,
                   "chemdt_s": 60.0, "gas_chem": True, "state_bytes": 41_556 * 256,
                   "setup_s": 5.0, "trace": trace, "phases": {"steps": 10, "chem_calls": 1,
                                                              "rad_calls": 0, "main_s": 1.0,
                                                              "chem_s": 0.5, "rad_s": 0.0},
                   "peak_bytes": 2**30 * (r + 1), "allocator": {"num_device_alloc": r},
                   "main_peak_bytes": 2**29 * (4 - r),
                   "spans": {"steps": 10, "chem_calls": 1, "rad_calls": 0, "cards": 1,
                             "paths": {"main": {"device_s": main[r], "self_s": 0.0,
                                                "calls": 10, "steps": 10,
                                                "lead_median_s": 0.001,
                                                "launches": 900 + r, "kernel_s": 0.0,
                                                "idle_s": 0.01 * r}}}}
        parts.append({"records": records, "breakdown": {"device_ops": trace["device_ops"],
                                                        "idle_gaps": trace["idle_gaps"]},
                      "start": (0.0, "t"), "maxima": {"state": {"t": (0.0, 1.0, True, True)}},
                      "tiles": 1, "reference_s": 1.0, "host_peak_bytes": 1,
                      "check_phases": {}, "setup_phases": {},
                      "periods": [{"steps": 10, "own_s": 1.0, "barrier_s": 0.0,
                                   "exchanges": 40, "bytes_sent": 1000 * (r + 1)}] * 2,
                      "host": {"cores": 8},
                      "device": {"platform": "gpu", "kind": "card", "count": 1,
                                 "memory_peak_bytes": None, "power_limit_w": 700.0}})
    res = harness._mesh_result(cell, bench, True, (), parts)
    dev = res["device"]
    assert list(dev) == ["platform", "kind", "count", "memory_peak_bytes", "power_limit_w",
                         "busy_s", "window_s"]
    assert dev["count"] == 4 and dev["memory_peak_bytes"] == 4 * 2**30
    assert dev["busy_s"] == pytest.approx(sum(busy) / 4)
    assert dev["window_s"] == pytest.approx(sum(wall) / 4)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["idle_pct"] == pytest.approx(100 * (1 - sum(busy) / sum(wall)))
    bound = counts.kernel_bounds([16, 16, 12], 107, 4, counts.ros2_n_sub(60.0), 10,
                                 1)["advect_tracers"]
    assert m["advect_tracers_roofline"] == pytest.approx(100 * bound / sum(k4))
    assert m["launches_per_step"] == 100.0 and m["main_peak_gib"] == 2.0
    assert res["breakdown"]["device_ops"] == [["op0", 0.1]]
    assert res["correct"] is True and res["numbers"]["state_err"] == 0.0
    # the spans: seconds summed over the cards, read as their mean;
    # launches rank 0's; each rank's own under `ranks`
    records = res["records"]
    assert m["main_span_ms"] == pytest.approx(1e3 * sum(main) / 4 / 10)
    assert m["main_launches_per_step"] == 90.0
    assert records["spans"]["paths"]["main"]["idle_s"] == pytest.approx(0.06)
    assert [r["spans"]["main"]["device_s"] for r in records["ranks"]] == main
    assert [r["busy_s"] for r in records["ranks"]] == busy
    # the mesh's counts per step: each rank's, summed, each period's sum
    mesh = records["mesh"]
    assert mesh["exchanges_per_step"] == 16.0
    assert mesh["bytes_sent_per_step"] == 1000.0
    assert [r["bytes_sent_per_step"] for r in mesh["ranks"]] == [100.0, 200.0, 300.0, 400.0]
    assert mesh["periods"] == [{"steps": 10, "exchanges": 160, "bytes_sent": 10_000}] * 2


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_the_mesh_counts_and_spans_of_four_ranks(trace):
    """Four gloo ranks without the check (the mesh probe's runs): each
    rank's exchanges and bytes sent are the same in every period of the
    window and never 0; with --trace 1 every rank runs the spans' blocks,
    which join into card-seconds (rank 0's launches, each rank's own under
    ``ranks``)."""
    cell = _short(_mesh_cell(spec.benchmark()))
    cell["traffic"] = dict(cell["traffic"], max_periods=4)
    res = harness.measure(cell, spec.benchmark(), SEED, 1e9 if not trace else 0.0, trace,
                          CPU4, time.perf_counter(), check=False)
    assert res["correct"] is None and res["numbers"] == {} and res["checks"] == {}
    records = res["records"]
    mesh = records["mesh"]
    periods = mesh["periods"]
    assert len(periods) == (2 if trace else 4)     # traced: the profiled and the phases'
    assert all(p == periods[0] for p in periods) and periods[0]["steps"] == 2
    for r in mesh["ranks"]:
        assert r["exchanges_per_step"] > 0 and r["bytes_sent_per_step"] > 0
    assert mesh["exchanges_per_step"] == pytest.approx(
        sum(r["exchanges_per_step"] for r in mesh["ranks"]))
    assert mesh["exchanges_per_step"] == periods[0]["exchanges"] / 2
    for rank in records["ranks"]:
        assert len(rank["periods"]) == len(periods)
        assert rank["host"]["cores"] >= 1 and rank["host"]["cpu_s"] > 0
    if not trace:
        assert "spans" not in records
        return
    sp = records["spans"]
    assert sp["cards"] == 4 and sp["steps"] == 2
    assert sp["paths"]["main"]["device_s"] == pytest.approx(
        sum(r["spans"]["main"]["device_s"] for r in records["ranks"]))
    assert res["attempted"] == 2 + 2 + 2 * 2


def test_the_check_of_ranks_1_to_3_builds_the_grid_alone():
    """`Model.grid`, which ranks 1 to 3 build in place of the whole case,
    is the case's grid tensor for tensor."""
    from port_bench import case
    from port_bench.reference.runner import GRID_SOUNDINGS, Model
    from port_bench.reference.wrf.config import namelist
    cs = spec.workload(spec.benchmark(), "arc_block.main")["config_spec"]
    cs["namelist"]["domain"].update(SHAPE)
    model = Model(case.build_config(namelist, cs))
    assert cs["case"] in GRID_SOUNDINGS
    whole, _ = model.case(cs["case"], "cpu", **cs["case_args"])
    alone = model.grid(cs["case"], "cpu")
    assert vars(whole).keys() == vars(alone).keys()
    for k, v in vars(whole).items():
        w = getattr(alone, k)
        if isinstance(v, torch.Tensor):
            assert v.dtype == w.dtype and torch.equal(v, w), k
        else:
            assert v == w, k


def test_plan_keeps_tiles_within_the_columns():
    # config 5's block, with arc_block's bytes a column: two tiles of the block
    limit = tiles.FOLLOW_STATE_BYTES // 41_556
    plan = tiles.plan(500, 500, tiles.RING, limit)
    assert len(plan) == 2
    assert all((y1 - y0 + 2 * tiles.RING) * (x1 - x0 + 2 * tiles.RING) <= limit
               for y0, y1, x0, x1 in plan)
    covered = torch.zeros(500, 500, dtype=torch.int32)
    for y0, y1, x0, x1 in plan:
        covered[y0:y1, x0:x1] += 1
    assert bool((covered == 1).all())
    assert tiles.plan(16, 16, 24) == [(0, 16, 0, 16)]
    with pytest.raises(ValueError):
        tiles.plan(16, 16, 24, max_columns=100)


@pytest.mark.cuda
def test_a_mesh_on_one_card_is_correct():
    """The kernels' path on a 2x2 mesh (K4's seam route, the halos staged
    through the host by gloo, four ranks sharing the card) against the
    reference in ringed tiles at 64x64x20; the TF32 control in the port's
    place is not correct (run on the chip: python3 -m pytest -m cuda
    port_bench/tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = _mesh_cell(spec.benchmark())
    cell["config_spec"]["namelist"]["domain"].update(nx=64, ny=64, nz=20)
    res = harness.measure(cell, spec.benchmark(), 12345, 0.0, False, ["cuda:0"] * 4,
                          time.perf_counter(), precisions=("tf32",))
    assert res["correct"] is True, res["numbers"]
    assert res["device"]["count"] == 4 and res["numbers"]["tiles"] == 4
    assert res["numbers"]["control.tf32.correct"] is False, res["numbers"]
