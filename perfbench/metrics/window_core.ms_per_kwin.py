"""Host milliseconds of the program's ``"conditioning"``, ``"clustering"``
and ``"metrics"`` ranges over the traced stretch, per 1,000 windows the
stretch closed. It is read under the profiler, whose cost per operation
it includes: compare it only with itself."""

STAGES = ("conditioning", "clustering", "metrics")


def read(run):
    windows = sum(u.windows for u in run.traced)
    if run.trace is None or not windows or not any(s in run.trace.ranges for s in STAGES):
        return None
    return sum(run.trace.host_s(s) for s in STAGES) * 1e3 / (windows / 1e3)
