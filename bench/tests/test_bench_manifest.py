"""`BENCHMARK.json` against the contract's shape: names and units of the
allowed characters, every file found by name, every per-layer metric
moving an end-to-end metric that its cells report, bounds in range, and a
full check of 24 cells at `run_seconds` inside the time it is given."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert all(TEXT.match(w) for w in MAN["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_text():
    names = ([c["name"] for c in MAN["configs"]] + CELLS
             + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in MAN["per_layer"]:
        assert TEXT.match(m["layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    from harness.manifest import Cell
    c = Cell(cell, MAN)
    assert c.data_generator().make and c.reference().judge
    for m in c.per_layer:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()


def test_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for cell in CELLS:
        assert any(cell in m.get("workloads", CELLS) for m in MAN["per_layer"])


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()


def test_full_check_fits_its_time():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
