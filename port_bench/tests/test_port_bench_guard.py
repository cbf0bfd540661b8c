"""The import guard, what the reference and the harness import, and a run
that finds no card."""

import ast
import json
import os
import shutil
import subprocess
import sys

from port_bench import guard, spec

PORT = "wrfchem_arc_interactions_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module and n.level == 0:
            yield n.module


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_guard_compares_whole_top_level_names():
    mods = {"torch": 0, PORT: 0, f"{PORT}.models.driver": 0, "jaxtyping": 0,
            "wrfchem_arc_interactions_tpu_other": 0}
    assert guard.jax_modules(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "wrfchem_arc_interactions_tpu", "wrfchem_arc_interactions_tpu.models"):
        assert guard.jax_modules(dict(mods, **{bad: 0})) == [bad]


def test_reference_imports_nothing_of_the_port_or_jax():
    found = []
    for path in _sources(os.path.join(spec.HERE, "reference")):
        for name in _imports(path):
            if name.split(".")[0] in guard.FORBIDDEN | {PORT}:
                found.append((path, name))
    assert found == []


def test_harness_imports_no_jax():
    found = []
    for path in _sources(spec.HERE):
        for name in _imports(path):
            if name.split(".")[0] in guard.FORBIDDEN:
                found.append((path, name))
    assert found == []


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                           "arc_block.main", "--seed", "2147483653", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(spec.ROOT, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


def test_run_without_the_port_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert json.load(open(tmp_path / "BENCHMARK.json"))["paths"] == ["port_bench"]
