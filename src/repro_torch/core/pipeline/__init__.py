"""End-to-end RSO detection pipeline (paper Fig. 2), as a layered package.

* ``config``      — :class:`PipelineConfig` + per-stage route selectors.
* ``window_core`` — the per-window stage over a written-out window axis,
  and :func:`run_recording`, the loop driver (one window at a time).
* ``scan``        — the step core with a carry (:func:`make_core`),
  :func:`run_recording_scan`, the whole-recording driver, and
  :func:`run_many_scan`, one core call over a batch of recordings.
* ``event_core``  — the atlas event core (:func:`make_event_core`), the
  float event route's step core, which writes the persistent
  window-tagged atlas.
* ``stream``      — :class:`StreamingPipeline`, the live-feed driver.
* ``fleet``       — :class:`FleetPipeline`, N sensors through one step per
  round, over the dense or the ragged ingest wire.
* ``evaluate``    — truth matching, :func:`evaluate_detection` and the
  accuracy sweep :func:`threshold_sweep` (scan or fleet driver).
* ``oracles``     — host (numpy / Python loop) matching oracles.
"""
from repro_torch.core.pipeline.config import (  # noqa: F401
    PipelineConfig,
    _histogram_fn,
    _metrics_fn,
    atlas_shape,
    config_from_dict,
)
from repro_torch.core.pipeline.window_core import (  # noqa: F401
    WindowResult,
    _cluster,
    _condition,
    _tracker_fn,
    _window_core,
    make_process_window,
    run_recording,
)
from repro_torch.core.pipeline.scan import (  # noqa: F401
    ScanResult,
    make_atlas,
    make_core,
    run_many_scan,
    run_recording_scan,
)
from repro_torch.core.pipeline.event_core import make_event_core  # noqa: F401
from repro_torch.core.pipeline.stream import (  # noqa: F401
    StreamingPipeline,
    StreamState,
    empty_scan_result,
    stream_state_from_numpy,
    stream_state_to_numpy,
    tag_limit,
)
from repro_torch.core.pipeline.fleet import (  # noqa: F401
    DEFAULT_TIERS,
    FleetPipeline,
    FleetResult,
    FleetState,
    PendingRound,
    SensorCursor,
    SlotCarry,
    WireStats,
    make_fleet_step,
    make_wire_fn,
    slot_carry_from_numpy,
    slot_carry_to_numpy,
    tier_capacity,
)
from repro_torch.core.pipeline.evaluate import (  # noqa: F401
    Candidates,
    DetectionScore,
    collect_candidates,
    collect_candidates_fleet,
    collect_candidates_many,
    evaluate_detection,
    merge_candidates,
    score_threshold,
    threshold_sweep,
    track_positions,
    track_table,
)
from repro_torch.core.pipeline.oracles import (  # noqa: F401
    collect_candidates_loop,
    collect_candidates_numpy,
)
from repro_torch.core.tracking import init_tracks, tracker_step  # noqa: F401
