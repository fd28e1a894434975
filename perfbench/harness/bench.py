"""One run of one cell: set-up, the measured window (or the traced
stretch), the comparison with the plain reference, and the metrics.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json`` (whose
``driver`` names the module in ``harness/drivers/`` that drives the
program), its traffic and limits in ``workloads/<cell>.json``, and each
metric's reader in ``metrics/<metric>.py``. A later cell, configuration
or metric is new files and new entries.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = HERE.parent  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Unit:
    """A pass (archive) or a round (fleet) of the window."""

    events: int  # input events it carried
    windows: int  # windows it closed
    steps: int  # tracker steps the step core ran
    seconds: float  # host time: a pass, or a round from submit to host view
    spans: np.ndarray  # (stream, first window, windows) rows of what it produced
    submit_s: float | None = None  # a round's time inside feed_async


@dataclasses.dataclass
class Run:
    """What the metric readers see. ``units`` are the measured window's,
    untraced; ``traced`` those of the traced stretch that follows it in a
    ``--trace 1`` run (none otherwise)."""

    cell: dict
    config: dict
    traffic: dict
    units: list[Unit]
    window_s: float
    setup_s: float
    trace: object | None  # harness.trace.Trace of a --trace 1 run
    figures: list[dict]  # the reference's per-window figures, a stream
    params: object  # harness.reference.Params
    traced: list[Unit] = dataclasses.field(default_factory=list)

    def unit_figures(self, units: list[Unit]) -> list[dict]:
        """The figures of each of ``units``' windows."""
        lengths = np.array([len(next(iter(f.values()))) for f in self.figures], np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        flat = {k: np.concatenate([f[k] for f in self.figures]) for k in self.figures[0]}
        out = []
        for u in units:
            s, first, n = (u.spans[:, i] for i in range(3))
            idx = np.repeat(offsets[s] + first - np.cumsum(n) + n, n) + np.arange(int(n.sum()))
            out.append({k: v[idx] for k, v in flat.items()})
        return out


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no cell named {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(run)``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _mean_ms(units: list[Unit]) -> float:
    return 1e3 * sum(u.seconds for u in units) / max(len(units), 1)


def log(msg: str) -> None:
    import sys

    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the run must not load."""
    import sys

    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float, *,
             device: str = "cuda", control: bool = False, traffic: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result's fields and the rows
    of numbers compared. ``t_start``: the process's start on the host
    clock, where set-up begins. ``traffic`` replaces the workload file's
    traffic (the tests' small sizes). ``control``: the plain reference in
    bfloat16 stands in the program's place."""
    import torch

    from harness import compare as C
    from harness import reference as R
    from harness.trace import from_profiler

    bench = spec()
    cell = cell_of(bench, name)
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    work = load_json(HERE / "workloads" / f"{name}.json")
    traffic = work["traffic"] if traffic is None else traffic
    driver = importlib.import_module(f"harness.drivers.{config['driver']}")
    session = driver.Session(config, traffic, seed, device)
    on_card = torch.device(device).type == "cuda"
    session.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    session.done.clear()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() - t0 < seconds:
        session.step()
    session.drain()
    window_s = time.perf_counter() - t0
    units = list(session.done)
    log(f"set-up {setup_s:.2f} s, window {window_s:.2f} s, {len(units)} units")
    prof, traced = None, []
    if trace:
        # The traced stretch follows the window, so that the profiler's
        # cost per operation reaches no host-clock reading of the window.
        from torch.profiler import ProfilerActivity, profile

        session.done.clear()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        t_tr = time.perf_counter()
        with profile(activities=acts) as prof:
            for _ in range(traffic["trace_units"]):
                session.step()
            session.drain()
            if on_card:
                torch.cuda.synchronize()
        traced = list(session.done)
        log(f"traced stretch {time.perf_counter() - t_tr:.2f} s, {len(traced)} units; a unit "
            f"{_mean_ms(traced):.2f} ms traced against {_mean_ms(units):.2f} ms in the window")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    answers = session.answers()
    streams = session.streams()
    session.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    params = R.Params.from_config(config["pipeline"])
    t_ref = time.perf_counter()
    ref = R.run(streams, params, driver.Session.final, torch.float32, device)
    expected = session.count_check(ref)
    log(f"reference {time.perf_counter() - t_ref:.2f} s over {sum(len(r['starts']) for r in ref)} windows, "
        f"{len(answers.stream)} compared")
    if control:
        low = R.run(streams, params, driver.Session.final, torch.bfloat16, device)
        rows, _ = C.reference_rows(low, answers.stream, answers.window)
        answers = rows
    checks = C.compare(answers, ref, params.confirm_hits, expected)
    correct, rows = C.verdict(checks, work["limits"])
    t_tr = time.perf_counter()
    tr = from_profiler(prof) if prof is not None else None
    if tr is not None:
        log(f"trace read {time.perf_counter() - t_tr:.2f} s, {len(tr.device)} device operations")
    run = Run(cell, config, traffic, units, window_s, setup_s, tr, [r["figures"] for r in ref], params,
              traced)
    metrics = {}
    for m in metrics_for(bench, name, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=1, memory_peak_bytes=int(memory_peak))
    out = dict(correct=bool(correct), attempted=len(units) + len(traced), failed=0, metrics=metrics, device=dev)
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out
