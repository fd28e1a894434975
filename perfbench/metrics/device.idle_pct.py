"""The share of the traced stretch in which no operation (kernel, copy or
fill) runs on the device, from the union of the device's intervals in
``torch.profiler``'s trace."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
