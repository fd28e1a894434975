"""``BENCHMARK.json`` against the contract's limits on names, units and
lengths, and every file a cell is found by present."""
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [c["name"] for c in BENCH["workloads"]]


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p for p in BENCH["paths"])
    assert all(_text_ok(w) and not w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])
    texts = ("why", "layer", "source") if "file" in entry else ("why", "layer")
    for key in texts:
        if key in entry:
            assert _text_ok(entry[key])
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for cell in CELLS:
        mine = [m for m in METRICS if cell in m.get("workloads", [cell])]
        assert any(m["name"] == "setup_s" for m in mine)
        assert any(m["name"] in e2e and m["name"] != "setup_s" for m in mine)
        per = [m for m in mine if m["name"] not in e2e]
        assert per and all(m["moves"] in e2e and cell in e2e[m["moves"]].get("workloads", [cell])
                           for m in per)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    work = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    assert set(work) == {"traffic", "limits"}
    conf = next(c for c in BENCH["configs"]
                if c["name"] == next(w for w in BENCH["workloads"] if w["name"] == cell)["config"])
    assert json.loads((ROOT / conf["file"]).read_text())["source"] == conf["source"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_readers(metric):
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()


def test_files_under_paths_are_named_from_name_characters():
    for f in HERE.rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
