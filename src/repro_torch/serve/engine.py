"""Deprecated back-compat shim: the LM engine lives in
:mod:`repro_torch.serve.lm`, as the reference's moved to ``repro.serve.lm``.

Importing from ``repro_torch.serve.engine`` works but warns; import from
``repro_torch.serve.lm`` instead.
"""
import warnings

from repro_torch.serve.lm import (  # noqa: F401
    DualThresholdBatcher,
    EngineConfig,
    Request,
    ServingEngine,
)

warnings.warn(
    "repro_torch.serve.engine is deprecated; import the LM engine from "
    "repro_torch.serve.lm instead",
    DeprecationWarning,
    stacklevel=2,
)
