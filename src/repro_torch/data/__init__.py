"""Synthetic recordings, scenario families and the recording interchange
format for the port (numpy, seeded like the reference)."""
from repro_torch.data.synthetic import (  # noqa: F401
    KIND_NOISE,
    KIND_RSO,
    KIND_STAR,
    LENS_CONFIGS,
    SCENARIO_FAMILIES,
    Recording,
    RSOSpec,
    Scenario,
    make_fleet_recordings,
    make_recording,
    make_scenario,
    make_scenario_suite,
    make_validation_suite,
)
