"""The detection-serving stack of the port (``repro.serve`` without the
LM engine, the chaos harnesses and the constellation layer).

* ``batcher``  — the paper's dual-threshold admission policy as a
  generic, fake-clock-testable primitive.
* ``sessions`` — per-sensor session lifecycle (attach / feed / detach,
  monotone-timestamp enforcement, bounded queues with shed accounting,
  latency and backlog accounting, structured fault records).
* ``faults``   — :class:`FaultConfig`, the degraded-mode policy, and
  the session-keyed heartbeat / straggler adapter.
* ``service``  — :class:`DetectionService`: micro-batched detection
  serving over the slot-pooled fleet on the card, with per-session
  fault isolation and session export / adopt.
"""
from repro_torch.serve.batcher import (  # noqa: F401
    AdmissionConfig,
    DualThresholdAdmitter,
    drain,
)
from repro_torch.serve.faults import (  # noqa: F401
    FaultConfig,
    SessionHealth,
)
from repro_torch.serve.sessions import (  # noqa: F401
    COORD_LIMIT,
    SHED_DROP_OLDEST,
    SHED_POLICIES,
    SHED_REJECT,
    SensorSession,
    SessionError,
    SessionStats,
)
from repro_torch.serve.service import (  # noqa: F401
    DetectionService,
    ServedFeed,
    SessionExport,
    session_export_from_numpy,
    session_export_to_numpy,
)
