"""Host milliseconds of the program's ``"tracker"`` range over the traced
stretch, divided by the tracker steps the step core ran (a pass's longest
recording, a round's most windows of one sensor). It is read under the
profiler, whose cost per operation it includes: compare it only with
itself."""


def read(run):
    steps = sum(u.steps for u in run.traced)
    if run.trace is None or not steps or "tracker" not in run.trace.ranges:
        return None
    return run.trace.host_s("tracker") * 1e3 / steps
