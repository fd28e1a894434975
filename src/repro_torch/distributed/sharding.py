"""Slot-pool carry migration for the fleet driver.

The port of the carry half of ``repro.distributed.sharding``: a stacked
fleet carry (every leaf with the sensor dim leading) grows by
zero-padding that dim, since an all-zero slot is the fresh-stream
initial state, and shrinks by slicing it. Placing the carry on a device
mesh is not ported yet (ROADMAP §1 item 7: mesh sharding of the fleet).
"""
from __future__ import annotations

from typing import Any

import torch


def _map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every tensor of a tuple / NamedTuple tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    mapped = [_map(fn, leaf) for leaf in tree]
    return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)


def grow_fleet_carry(tree: Any, new_size: int) -> Any:
    """Zero-pad every leaf's leading sensor dim to ``new_size`` slots."""

    def pad(leaf: torch.Tensor) -> torch.Tensor:
        extra = new_size - leaf.shape[0]
        if extra < 0:
            raise ValueError(
                f"fleet carry has {leaf.shape[0]} slots, cannot shrink to {new_size}"
            )
        if extra == 0:
            return leaf
        return torch.cat([leaf, leaf.new_zeros((extra,) + tuple(leaf.shape[1:]))])

    return _map(pad, tree)


def shrink_fleet_carry(tree: Any, new_size: int) -> Any:
    """Keep the first ``new_size`` slots of every leaf (the caller
    guarantees the dropped tail slots are free)."""
    if new_size < 1:
        raise ValueError(f"need at least one slot, got {new_size}")

    def cut(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.shape[0] < new_size:
            raise ValueError(f"fleet carry has {leaf.shape[0]} slots, cannot take {new_size}")
        return leaf[:new_size]

    return _map(cut, tree)
