"""``BENCHMARK.json`` within its contract, and every entry's file found by
its name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in M["paths"])
    assert len(M["command"]) <= 32 and all(text_ok(w) and not w.startswith("/") for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_command_names_only_files_under_paths():
    for w in M["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in M["paths"]) and (ROOT / w).is_file()


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"]) and text_ok(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and text_ok(w["why"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text_ok(m["layer"])
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in M[group]}) == len(M[group])
    every = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(every)) == len(every)
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])


def test_setup_s_and_every_cell_reports_an_end_to_end_and_a_layer_metric():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e
    cells = [w["name"] for w in M["workloads"]]
    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]
    for cell in cells:
        assert sum(reports(m, cell) for m in M["end_to_end"] if m["name"] != "setup_s") >= 1
        assert sum(reports(m, cell) for m in M["per_layer"]) >= 1
    for m in M["per_layer"] + M["end_to_end"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_each_configuration_is_a_file_of_its_own(c):
    path = ROOT / c["file"]
    assert any(c["file"].startswith(p + "/") for p in M["paths"]) and path.is_file()
    assert path.name == f"{c['name']}.json" and json.loads(path.read_text())["name"] == c["name"]


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_each_traffic_mix_is_a_data_file_found_by_name(w):
    path = ROOT / "kvbench" / "traffic" / f"{w['traffic']}.json"
    assert json.loads(path.read_text())["name"] == w["traffic"]


@pytest.mark.parametrize("m", M["end_to_end"] + M["per_layer"], ids=lambda m: m["name"])
def test_each_metric_is_a_reader_of_its_own(m):
    from kvbench import harness

    assert callable(harness.metric_reader(m["name"]))


def test_setup_s_takes_the_bound_of_a_quarter():
    b = {m["name"]: m["bound"] for m in M["end_to_end"]}
    assert b["setup_s"] == 0.25
