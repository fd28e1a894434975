"""The 95th percentile, over every round of the measured window (untraced),
of the host time from a round's ``feed_async`` call to its detections on
the host (``PendingRound.result()`` and the host view of every sensor)."""
import numpy as np


def read(run):
    lat = [u.seconds for u in run.units if u.submit_s is not None]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
