"""Roofline terms from the op counter's counts, on NVIDIA H100 constants.

The port of ``repro.launch.roofline``. Three terms per (arch x shape x
mesh), in seconds:

  compute    = FLOPs_per_device / peak bf16 FLOP/s
  memory     = bytes_per_device / HBM bandwidth
  collective = collective_bytes_per_device / NVLink bandwidth (one direction)

The reference reads per-device counts from the optimized post-SPMD HLO.
The port counts the aten ops that a step dispatches
(:mod:`repro_torch.launch.op_analysis`); eager PyTorch has no SPMD
partitioner, so :func:`extract_terms` splits a step's global FLOPs and
bytes evenly over ``n_devices``, an ideal split (the reference's
post-SPMD counts include replicated work). Collective bytes are taken as
counted: a process counts the collectives it runs. Where they are
unknown (no process group: the dry run), they are ``None`` and the
collective term with them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class RooflineTerms:
    flops: float  # per-device FLOPs
    hbm_bytes: float  # per-device bytes moved
    coll_bytes: float | None  # per-device collective payload bytes; None = unknown
    n_devices: int
    coll_breakdown: dict = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float | None:
        return None if self.coll_bytes is None else self.coll_bytes / LINK_BW

    def _terms(self) -> dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self._terms().values())

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "n_devices": self.n_devices,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "coll_breakdown": self.coll_breakdown,
        }


def extract_terms(counts: dict, n_devices: int) -> RooflineTerms:
    """Per-device roofline terms from :func:`op_analysis.analyze`'s counts
    of a whole step: FLOPs and bytes split evenly over ``n_devices``,
    collective bytes as counted (``None`` stays ``None``)."""
    return RooflineTerms(
        flops=counts["flops"] / n_devices,
        hbm_bytes=counts["bytes"] / n_devices,
        coll_bytes=counts["coll_bytes"],
        n_devices=n_devices,
        coll_breakdown=counts["coll_breakdown"],
    )


def model_flops(
    param_count: int,
    tokens: int,
    active_param_count: int | None = None,
    kind: str = "train",
) -> float:
    """MODEL_FLOPS: 6*N*D for training (fwd+bwd), 2*N*D for inference.
    MoE uses N_active."""
    n = active_param_count if active_param_count is not None else param_count
    factor = 6.0 if kind == "train" else 2.0
    return factor * n * tokens
