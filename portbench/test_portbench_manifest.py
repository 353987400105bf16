"""BENCHMARK.json against the rules it is checked by, and every cell and
configuration found by name."""

import json
import math
import re
from pathlib import Path

import pytest

from portbench import spec

BENCH = spec.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = Path(spec.__file__).resolve().parent / "metrics"


def _line(text, most=200):
    return (isinstance(text, str) and 1 <= len(text) <= most
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(spec.MANIFEST.read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.fullmatch(p) and not p.startswith("/") \
            and ".." not in p.split("/")
        assert (spec.ROOT / p).is_dir()
    for word in cmd:
        assert not word.startswith("/") and ".." not in word.split("/")
        if (spec.ROOT / word).is_file():
            assert any(word.startswith(p + "/") for p in paths)


def test_run_seconds_fit_the_check_with_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.fullmatch(key) and not WIDTHS.search(key)
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.fullmatch(w[k]) for k in ("name", "config",
                                                  "traffic"))
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(cells)
    assert {w["config"] for w in BENCH["workloads"]} == set(names)
    metric_names = []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= set(cells)
        metric_names.append(m["name"])
    assert len(set(metric_names)) == len(metric_names)


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25


def test_per_layer_metrics_move_an_end_to_end_metric_and_have_a_reader():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        assert m["moves"] in e2e
        reporting = e2e[m["moves"]].get("workloads")
        if reporting is not None:
            assert set(m["workloads"]) <= set(reporting)
        assert (METRICS / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    # one layer, one spelling
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_by_name(name):
    cell = spec.cell(name)
    assert cell.config["name"] == [w for w in BENCH["workloads"]
                                   if w["name"] == name][0]["config"]
    assert cell.traffic["policy"] in ("balanced_pandas", "pandas_po2")
    assert cell.driver.__name__ == "portbench.drivers.fleet_study"
    assert cell.driver.cells_per_study(cell) == 624
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    assert cell.driver.seeds(cell, 2**31) == [8 * 2**31 + i
                                             for i in range(8)]
    assert 0 <= cell.traffic["warmup"] < cell.traffic["horizon"]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_each_configuration_loads_by_name(name):
    entry = [c for c in BENCH["configs"] if c["name"] == name][0]
    config = json.loads((spec.ROOT / entry["file"]).read_text())
    assert config["name"] == name
    m, groups = config["num_servers"], config["group_sizes"]
    assert all(m % g == 0 for g in groups)
    assert len(config["rates"]) == len(groups) + 2
    assert sorted(entry["reduced"]) == sorted(config["reduced_from"])
    assert math.isclose(config["p_hot"], 0.5)
