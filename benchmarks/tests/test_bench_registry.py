"""``BENCHMARK.json`` against its contract and its files: every cell,
configuration, traffic mix and metric is found by name, and each per-layer
metric's cells report the end-to-end metric it moves."""

import ast
import json
import re

import pytest

from benchmarks.harness import runner

BENCH = json.loads((runner.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(HIDDEN|INTERMEDIATE|FFN|HEAD|LATENT|STATE|PROJ|_DIM$|_RANK$|EXPERTS_PER)")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmarks/run.py"]
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {"setup_s"} < {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_configs_are_found_and_reduce_no_width():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmarks/configs/")
        f = json.loads((runner.ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert sorted(f["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key), key
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = runner.Cell(cell, BENCH)
    assert c.entry["chips"] in (1, 4)
    assert c.spec["driver"] and (runner.BENCH_DIR / "harness" /
                                 f"{c.spec['driver']}_driver.py").exists()
    assert set(c.spec["limits"]) and all(v > 0 for v in c.spec["limits"].values())
    assert c.mix["kind"]
    e2e = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer()
    for m in c.per_layer():
        assert m["moves"] in e2e


def test_four_chip_cells_are_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader_that_agrees(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    mod = runner.load_metric(metric)
    assert (mod.UNIT, mod.SOURCE, mod.LAYER, mod.MOVES) == \
        (entry["unit"], entry["source"], entry["layer"], entry["moves"])
    assert callable(mod.read)


def test_the_command_names_no_file_outside_paths():
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (runner.ROOT / BENCH["command"][1]).exists()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_nothing_imports_jax_and_the_reference_imports_no_program():
    for path in runner.BENCH_DIR.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in runner.FORBIDDEN_MODULES, (path, mod)
    for path in (runner.BENCH_DIR / "reference").rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top != "twotowermlretrieval_tpu_torch", (path, mod)
            assert not mod.startswith("benchmarks.harness"), (path, mod)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "twotowermlretrieval_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxfoo", types.ModuleType("x"))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert runner.forbidden_modules() == ["jax"]


def test_each_pair_of_config_and_traffic_is_one_cell():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
