"""Production mesh descriptions and the NVIDIA H100 constants of the roofline.

The port of ``repro.launch.mesh``. The reference builds ``jax.make_mesh``
meshes of 256 or 512 TPU v5e-like chips. The sharding rules
(:mod:`repro_torch.distributed.sharding`) and the dry run
(:mod:`repro_torch.launch.dryrun`) read only a mesh's axis names and sizes,
as the reference's own tests read ``_FakeMesh``, so a mesh here is a
description with no device behind it: making one touches no card and
starts no process group.

A real ``torch.distributed.DeviceMesh`` over a process group, and the
reference's ``use_mesh``, wait for the multi-device slice (ROADMAP items
7-8); so does ``shard_map``, which the port has no counterpart of.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh, outermost axis first."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axes {self.axis_names}")

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 devices) or 2x16x16 two-pod (512 devices)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Arbitrary mesh helper for tests and examples (e.g. (4, 2) over
    ("data", "model"))."""
    return Mesh(tuple(shape), tuple(axes))


# NVIDIA H100 SXM5 constants for the roofline model (NVIDIA's data sheet,
# dense rates without sparsity, at the 700 W power limit). They replace the
# reference's TPU v5e figures.
PEAK_FLOPS_BF16 = 989e12  # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s per card
# NVLink 4 on the SXM part: 900 GB/s a card both ways, 450 GB/s in each
# direction. The counterpart of the reference's per-direction ICI_BW.
LINK_BW = 450e9
