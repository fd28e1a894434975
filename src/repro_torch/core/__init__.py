"""Core library: the paper's grid-clustering RSO detection pipeline."""
from repro_torch.core.events import (  # noqa: F401
    BatcherConfig,
    EventBatch,
    WindowedEvents,
    coincidence_counts,
    dual_threshold_bounds,
    dual_threshold_closed_bounds,
    pack_bounds,
    pack_bounds_into,
    pack_words,
    pad_windows,
    persistent_event_filter,
    roi_filter,
    unpack_words,
)
from repro_torch.core.grid_clustering import (  # noqa: F401
    Clusters,
    GridConfig,
    form_clusters,
    merge_adjacent,
    quantize,
)
from repro_torch.core.pipeline import (  # noqa: F401
    Candidates,
    DetectionScore,
    PipelineConfig,
    ScanResult,
    collect_candidates,
    config_from_dict,
    evaluate_detection,
    run_recording_scan,
    score_threshold,
)
from repro_torch.core.tracking import (  # noqa: F401
    TrackerConfig,
    TrackState,
    confirmed,
    init_tracks,
    track_recording,
    tracker_step,
    tracks_from_numpy,
    tracks_to_numpy,
)
