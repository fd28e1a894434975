"""Synthetic recordings for the port (numpy, seeded like the reference)."""
from repro_torch.data.synthetic import (  # noqa: F401
    KIND_NOISE,
    KIND_RSO,
    KIND_STAR,
    LENS_CONFIGS,
    Recording,
    make_recording,
    make_validation_suite,
)
