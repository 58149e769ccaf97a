"""BENCHMARK.json against the benchmark's contract, and the harness's
imports: nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units_use_allowed_characters():
    names = [m["name"] for m in _metrics()] + [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in (_metrics(), BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)


def test_one_line_texts():
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        mine = {n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [])]
        assert layers and all(m["moves"] in mine for m in layers)


def test_each_cell_and_metric_has_its_files():
    bench = ROOT / "benchmark"
    for w in BENCH["workloads"]:
        traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench / "drivers" / f"{traffic['driver']}.py").is_file()
        limits = json.loads((bench / "limits" / f"{w['name']}.json").read_text())
        assert limits
    for m in BENCH["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["name"].split(".")[0], set()).add(m["layer"])


def test_configurations_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def _top_level_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("banned", ["jax", "jaxlib", "flax", "seq2squiggle_tpu"])
def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package(banned):
    found = [str(p) for p in (ROOT / "benchmark").rglob("*.py")
             if p.parent.name != "tests" and banned in set(_top_level_imports(p))]
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    for p in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert "seq2squiggle_tpu_torch" not in set(_top_level_imports(p)), p


def test_the_whole_name_check_tells_the_port_from_the_jax_package(monkeypatch):
    import sys
    import types

    from benchmark.harness.core import banned_modules_loaded

    before = set(banned_modules_loaded())
    monkeypatch.setitem(sys.modules, "seq2squiggle_tpu_torch.stand_in", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_stand_in", types.ModuleType("y"))
    assert set(banned_modules_loaded()) == before
    monkeypatch.setitem(sys.modules, "seq2squiggle_tpu.stand_in", types.ModuleType("z"))
    assert "seq2squiggle_tpu" in banned_modules_loaded()
