"""The detection-serving stack of the port (``repro.serve`` without the
LM engine).

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
* ``chaos``    — deterministic seeded fault-injection harness pinning
  the isolation and bit-identity guarantees.
* ``constellation`` — :class:`ConstellationService`: sensor sessions
  partitioned over N service shards (one device each, or sharing one),
  with the placement/rebalance planner, whole-shard rescue, and the
  compressed cross-shard exchange (DESIGN.md Sec. 15).
* ``chaos_shards`` — the shard-level chaos harness (whole-shard stalls,
  forced migrations/rebalances on top of the per-sensor taxonomy).
"""
from repro_torch.serve.batcher import (  # noqa: F401
    AdmissionConfig,
    DualThresholdAdmitter,
    drain,
)
from repro_torch.serve.chaos import (  # noqa: F401
    FAULT_TAXONOMY,
    ChaosConfig,
    ChaosHarness,
    ChaosReport,
)
from repro_torch.serve.chaos_shards import (  # noqa: F401
    SHARD_FAULT_TAXONOMY,
    ShardChaosConfig,
    ShardChaosHarness,
    ShardChaosReport,
)
from repro_torch.serve.constellation import (  # noqa: F401
    ConstellationFeed,
    ConstellationService,
    CrossShardExchange,
    partition_devices,
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
