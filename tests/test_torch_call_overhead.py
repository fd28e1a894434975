"""The pair summary of ``tools/torch_call_overhead.py`` (no card needed):
consecutive parent/change lines form a pair, each run reads as the mean
of its fleet p50s, and the verdict follows the parent's quartile spread."""
import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_call_overhead", ROOT / "tools" / "torch_call_overhead.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path, parent, change):
    """Alternating pairs: parent first in even pairs, change first in odd."""
    lines = []
    for i, (p, c) in enumerate(zip(parent, change)):
        pair = [("parent", p), ("change", c)]
        for label, v in (pair if i % 2 == 0 else pair[::-1]):
            lines.append(json.dumps(dict(label=label, fleet_kernel=dict(p50_ms=[v - 0.5, v + 0.5]))))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("parent, change, verdict, won", [
    ([10, 11, 12, 10, 11, 12, 10, 11, 12, 11], [14, 15, 13, 14, 15, 13, 14, 15, 13, 14],
     "regression", 0),
    ([14, 15, 13, 14, 15, 13, 14, 15, 13, 14], [10, 11, 12, 10, 11, 12, 10, 11, 12, 11],
     "gain", 10),
    ([10, 14, 12, 10, 14, 12, 10, 14, 12, 11], [11, 13, 12.5, 9, 14.5, 12, 10, 13, 12, 11.5],
     "unresolved", 3),
])
def test_summarize_pairs(tmp_path, capsys, parent, change, verdict, won):
    f = tmp_path / "pairs.jsonl"
    _write(f, parent, change)
    assert _tool().summarize(str(f)) == 0
    out = json.loads(capsys.readouterr().out)
    row = out["fleet_kernel"]
    assert out["pairs"] == 10
    assert row["verdict"] == verdict and row["change_won"] == won
    assert row["parent_q1_median_q3"][1] == pytest.approx(float(sorted(parent)[4] + sorted(parent)[5]) / 2)
