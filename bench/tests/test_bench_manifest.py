"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re

import pytest

from bench.harness import manifest

M = manifest.load()
E2E = {m["name"]: m for m in M["end_to_end"]}
PL = {m["name"]: m for m in M["per_layer"]}
CELLS = {w["name"]: w for w in M["workloads"]}
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(M) == TOP
    assert 1 <= int(M["run_seconds"]) <= 51
    assert M["run_seconds"] == int(M["run_seconds"])
    assert len(json.dumps(M)) <= 64 * 1024


def test_command_and_paths():
    assert M["paths"] == ["bench"]
    assert 1 <= len(M["command"]) <= 32
    for word in M["command"]:
        assert ONE_LINE.match(word)
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert word.startswith("bench/")
            assert (manifest.ROOT / word).is_file()
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert (manifest.ROOT / p).is_dir()


def test_names_and_units():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    names += list(CELLS) + [c["name"] for c in M["configs"]]
    names += [w["config"] for w in M["workloads"]]
    names += [w["traffic"] for w in M["workloads"]]
    for c in M["configs"]:
        names += c["reduced"]
    for n in names:
        assert manifest.NAME.match(n), n
    assert len(set(E2E) | set(PL)) == len(E2E) + len(PL)
    assert len(CELLS) == len(M["workloads"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        assert c["file"].startswith("bench/configs/")
        assert (manifest.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and ONE_LINE.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert ONE_LINE.match(m["layer"])


def test_setup_and_every_cell_reports_enough():
    assert "setup_s" in E2E
    for cell in CELLS:
        e2e = [m["name"] for m in manifest.end_to_end(M, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(M, cell)


def test_per_layer_moves_and_workloads():
    for m in M["per_layer"]:
        assert m["moves"] in E2E, m
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS), m
        moved = E2E[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
        assert (manifest.BENCH / "layers" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") and m["name"] != "step_roofline":
            assert m["unit"] == "%"
            kernel = m["name"].removesuffix("_roofline")
            assert (manifest.BENCH / "ops" / f"{kernel}.py").is_file()
    layers_of = {}
    for m in M["per_layer"]:
        layers_of.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers_of.values())


def test_configs_and_workload_files():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    for c in M["configs"]:
        data = manifest.config(c["name"])
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert data["precision"] in ("float64", "float32")
        for kind in ("drivers", "reference"):
            assert (manifest.BENCH / kind / f"{c['name']}.py").is_file()
    for name, w in CELLS.items():
        data = manifest.workload(name)
        assert data["config"] == w["config"]
        assert data["traffic"]["name"] == w["traffic"]
        assert data["chips"] == w["chips"] and data["why"] == w["why"]
        assert data["limits"] and all(v >= 0 for v in data["limits"].values())


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("cells", [24])
def test_full_check_fits(cells):
    """A full check of 24 cells fits the driver's 43200 seconds."""
    runs = 2 + 14 * cells
    total = runs * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
