"""The benchmark is driven by data: cells, configurations, traffic mixes,
limits and metrics are found by name from files alone, and BENCHMARK.json
keeps to the form the harness reads."""

import json
import os
import re
import shutil

import pytest

from port_bench import case, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _admitted(bench: dict, here: str = spec.HERE) -> None:
    """The cells' chips: 1 or 4, each cell's its configuration's mesh (one
    block a card), and at most max(1, cells // 4) cells on 4 chips."""
    for w in bench["workloads"]:
        cell = spec.workload(bench, w["name"], here=here)
        assert cell["chips"] in (1, 4), w["name"]
        my, mx = spec.mesh_shape(cell)
        assert my * mx == cell["chips"]
    four = sum(1 for w in bench["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(bench["workloads"]) // 4), f"{four} cells on 4 chips"


def test_every_cell_finds_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.workload(bench, w["name"])
        assert cell["config_spec"]["name"] == w["config"]
        assert {"start_err", "state_err"} <= set(cell["limits"])
        for m in spec.metrics_for(bench, w["name"], trace=False) + \
                spec.metrics_for(bench, w["name"], trace=True):
            assert callable(spec.reader(m["name"]))
    _admitted(bench)


def _with_cells(tmp_path, cells):
    """A copy of the files with the four-card `arc_mesh` configuration (a
    2x2 `parallel` mesh) and `cells` added: (name, configuration, chips)."""
    here = tmp_path / "port_bench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.load(open(here / "configs" / "arc_block.json"))
    cfg["namelist"]["domain"].update(nx=1000, ny=1000)
    cfg["namelist"]["parallel"] = {"mesh_y": 2, "mesh_x": 2}
    json.dump(cfg, open(here / "configs" / "arc_mesh.json", "w"))
    bench = spec.benchmark()
    bench["configs"].append(dict(bench["configs"][0], name="arc_mesh",
                                 file="port_bench/configs/arc_mesh.json"))
    for name, config, chips in cells:
        shutil.copy(here / "limits" / "arc_block.main.json", here / "limits" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": config, "traffic": "alarm_periods",
                                   "chips": chips, "why": "test"})
    return bench, str(here)


@pytest.mark.parametrize("cells, admitted", [
    ([("arc_mesh.main", "arc_mesh", 4)], True),
    ([("arc_block.four", "arc_block", 4)], False),
    ([("arc_mesh.main", "arc_mesh", 4), ("arc_mesh.more", "arc_mesh", 4)]
     + [(f"arc_block.c{i}", "arc_block", 1) for i in range(4)], False),
    ([("arc_mesh.main", "arc_mesh", 4), ("arc_mesh.more", "arc_mesh", 4)]
     + [(f"arc_block.c{i}", "arc_block", 1) for i in range(5)], True),
], ids=["mesh_2x2_on_4", "4_chips_on_1x1", "second_4_of_7", "second_4_of_8"])
def test_a_cell_of_several_cards_is_admitted_by_its_mesh(tmp_path, cells, admitted):
    """A cell on 4 chips whose configuration is a 2x2 mesh is admitted by
    files alone; 4 chips on a 1x1 mesh are not; a second cell on 4 chips
    needs 8 cells in all (arc_block.main among them)."""
    bench, here = _with_cells(tmp_path, cells)
    if admitted:
        _admitted(bench, here)
    else:
        with pytest.raises((AssertionError, ValueError)):
            _admitted(bench, here)


def test_benchmark_json_form():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[g]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for c in bench["configs"]:
        path = os.path.join(spec.ROOT, c["file"])
        assert c["file"].startswith("port_bench/") and os.path.exists(path)
        assert sorted(c["reduced"]) == sorted(json.load(open(path))["reduced"])
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        assert os.path.exists(os.path.join(spec.HERE, "metrics", f"{m['name']}.py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = {m["name"] for m in spec.metrics_for(bench, cell, False)}
        assert "setup_s" in reported and len(reported) >= 2
        for m in spec.metrics_for(bench, cell, True):
            assert m["moves"] in reported


@pytest.mark.parametrize("name, smoke_cfg", [("arc_block", "_cfg4")])
def test_configs_build_the_drivers_packages(name, smoke_cfg):
    """arc_block is chip_smoke.py's config 5 block (`_cfg4` at 500x500x60
    from noon)."""
    import chip_smoke
    from wrfchem_arc_interactions_tpu_torch.config import namelist
    built = case.build_config(namelist, spec.config(name))
    assert built == getattr(chip_smoke, smoke_cfg)(500, 500, 60,
                                                   start_date="2000-06-20_12:00:00")
    assert case.aerosol_bins(spec.config(name)) == 4


def test_a_cell_config_traffic_and_metric_are_added_as_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric by adding files and entries; no code changes."""
    here = tmp_path / "port_bench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.benchmark()
    cfg = json.load(open(here / "configs" / "arc_block.json"))
    cfg["namelist"]["domain"].update(nx=250, ny=250)
    json.dump(cfg, open(here / "configs" / "arc_quarter.json", "w"))
    json.dump({"warmup_steps": 2, "period_steps": 10, "check_steps": 2, "traced_periods": 1,
               "max_periods": 5, "theta_amp_k": 0.2, "seeded_rel": 0.2},
              open(here / "traffic" / "stormy.json", "w"))
    json.dump({"start_err": {"limit": 0.0}, "state_err": {"limit": 1e-4}},
              open(here / "limits" / "arc_quarter.stormy.json", "w"))
    (here / "metrics" / "periods_traced.py").write_text(
        "def read(records):\n    t = records.get('trace')\n"
        "    return None if t is None else t['steps'] / 10\n")
    bench["workloads"].append({"name": "arc_quarter.stormy", "config": "arc_quarter",
                               "traffic": "stormy", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "periods_traced", "unit": "periods",
                               "better": "higher", "source": "program_counter",
                               "layer": "run loop: models/driver.py Simulation",
                               "moves": "gridpoints_per_s",
                               "workloads": ["arc_quarter.stormy"]})
    cell = spec.workload(bench, "arc_quarter.stormy", here=str(here))
    assert cell["config_spec"]["namelist"]["domain"]["nx"] == 250
    assert cell["traffic"]["theta_amp_k"] == 0.2
    out = spec.read_metrics(bench, "arc_quarter.stormy", True,
                            {"trace": {"steps": 20}}, here=str(here))
    assert out["periods_traced"] == {"value": 2.0, "unit": "periods"}
    # the metric is not read in the cells it does not name
    assert "periods_traced" not in [m["name"] for m in
                                    spec.metrics_for(bench, "arc_block.main", True)]
