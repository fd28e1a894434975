"""End-to-end RSO detection pipeline (paper Fig. 2), as a layered package.

* ``config``      — :class:`PipelineConfig` + per-stage route selectors.
* ``window_core`` — the per-window stage over a written-out window axis.
* ``scan``        — :func:`run_recording_scan`, the whole-recording driver.
* ``evaluate``    — truth matching and :func:`evaluate_detection`.
"""
from repro_torch.core.pipeline.config import (  # noqa: F401
    PipelineConfig,
    _histogram_fn,
    _metrics_fn,
    config_from_dict,
)
from repro_torch.core.pipeline.window_core import (  # noqa: F401
    _cluster,
    _condition,
    _window_core,
)
from repro_torch.core.pipeline.scan import ScanResult, run_recording_scan  # noqa: F401
from repro_torch.core.pipeline.evaluate import (  # noqa: F401
    Candidates,
    DetectionScore,
    collect_candidates,
    evaluate_detection,
    score_threshold,
    track_positions,
    track_table,
)
from repro_torch.core.tracking import init_tracks, tracker_step  # noqa: F401
