"""BENCHMARK.json and the files it names: every configuration, traffic mix
and metric is found by its name, and the file keeps to the contract's shape."""

import json
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    c = harness.cell(workload, BENCH)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["name"] == c["workload"]["traffic"]
    names = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        reader = harness.load_module(harness.find("metrics", m["name"], ".py"))
        assert callable(reader.read)


def test_names_units_and_keys():
    seen = set()
    for section, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                          ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in BENCH[section]:
            assert set(entry) == keys
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
            assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for entry in BENCH["configs"]:
        config = harness.load_json(harness.ROOT / entry["file"])
        assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
        assert config["source"] == entry["source"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        harness.cell("no.such.cell", BENCH)
    with pytest.raises(FileNotFoundError):
        harness.find("traffic", "no_such_mix", ".json")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_deck_sizes_and_seeds(config):
    cfg = harness.load_json(harness.find("configs", config, ".json"))
    a = harness.deck_arrays(cfg, 2**31 + 7)
    b = harness.deck_arrays(cfg, 2**31 + 7)
    c = harness.deck_arrays(cfg, 5)
    assert len(a[0]) == cfg["particles"]
    assert (a[0] == b[0]).all() and not (a[0] == c[0]).all()
    moved = abs(a[0] - harness.load_module(harness.find("decks", cfg["deck"], ".py")).build(
        cfg["geometry"])[0]).max()
    assert 0 < moved <= 1.01 * cfg["jitter_dx"] * cfg["constants"]["dx"]
    lo, hi = cfg["check"]["later"]
    assert lo <= harness.later_output(cfg, 2**31 + 7) <= hi
