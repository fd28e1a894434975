"""Host milliseconds inside ``FleetPipeline.feed_async`` (validation,
windowing, packing the wire, launching the round), by the harness's clock
around the call, averaged over every round of the measured window
(untraced)."""


def read(run):
    sub = [u.submit_s for u in run.units if u.submit_s is not None]
    return sum(sub) / len(sub) * 1e3 if sub else None
