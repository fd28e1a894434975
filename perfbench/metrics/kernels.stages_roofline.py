"""The least time of the window stages' work (clustering and metrics, and
on the fleet the wire decode), counted from the generated inputs by the
frozen counts in ``harness/costs.py``, as a share of the device time of
the kernels launched inside the program's ``"clustering"``, ``"metrics"``
and ``"wire decode"`` ranges over the traced stretch. It reads the same
work whatever kernels do it."""
from harness import costs

RANGES = ("clustering", "metrics", "wire decode")


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.launched_in_s(RANGES)
    if not device_s:
        return None
    p = run.params
    wire = run.config.get("fleet", {}).get("n_sensors") if run.config.get("fleet", {}).get("wire") == "ragged" else None
    least = sum(costs.least_seconds(f, p.capacity, p.max_clusters, p.n_cells, wire)
                for f in run.unit_figures(run.traced) if f is not None)
    return 100.0 * least / device_s
