"""Input events of the window's completed passes or rounds over all the
window's host time (the window ends with the first unit to finish after
``--seconds``)."""


def read(run):
    if not run.units or run.window_s <= 0:
        return None
    return sum(u.events for u in run.units) / run.window_s
