"""Parameter and activation sharding rules (DP / FSDP / TP / EP), and
slot-pool carry migration for the fleet driver.

The port of ``repro.distributed.sharding``. The rules: a leaf's spec is
derived from its parameter's *name* (right-aligned against the leaf's
shape, so the stacked cycle dims of the reference's layout, or none at
all in the port's per-layer parameters, work alike), with divisibility
checks against the mesh: a dim that does not divide by its axis size
falls back to replication. One rule set stays valid across all ten
architectures (40-head MLA, 12-head VLM, 4-head xLSTM, ...).

A spec is a plain tuple, the entries of the reference's ``PartitionSpec``
in order: one entry a dim (``None``, an axis name, or a tuple of names
for a dim sharded over several axes), or ``()`` for a leaf whose name has no
rule, as the reference's ``P()``. A mesh is
:class:`repro_torch.launch.mesh.Mesh`, axis names and sizes only: the
specs feed the dry run (:mod:`repro_torch.launch.dryrun`); placing
tensors over a process group waits for the multi-device slice (ROADMAP
items 7-8), as does ``named``.

Axis semantics:
  dp   — batch data parallelism (('pod','data') on the multi-pod mesh)
  fsdp — weight/optimizer sharding over the data axis (ZeRO-3 style)
  tp   — tensor parallelism over the model axis; also hosts EP (experts)

The carry half: a stacked fleet carry (every leaf with the sensor dim
leading) grows by zero-padding that dim, since an all-zero slot is the
fresh-stream initial state, and shrinks by slicing it. Placing the carry
on a device mesh is not ported yet (ROADMAP §1 item 7: mesh sharding of
the fleet).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    dp: tuple[str, ...] = ("data",)
    fsdp: str | None = "data"
    tp: str | tuple[str, ...] | None = "model"
    ep: str | None = "model"
    # Pure expert parallelism: shard expert weights ONLY over ep. The
    # default also FSDPs the contracting d_model dim, which makes every
    # expert product a partial-sum all-reduce of the (E, C, ff) dispatch
    # tensor.
    moe_ep_only: bool = False


TRAIN_RULES = ShardingRules()
MULTIPOD_TRAIN_RULES = ShardingRules(dp=("pod", "data"))
SERVE_RULES = ShardingRules(fsdp=None)
MULTIPOD_SERVE_RULES = ShardingRules(dp=("pod", "data"), fsdp=None)
# 2D tensor parallelism for tiny-batch serving (long-context decode with
# global_batch=1 leaves the data axis idle: fold it into TP).
SERVE_2D_RULES = ShardingRules(fsdp=None, tp=("model", "data"))
MULTIPOD_SERVE_2D_RULES = ShardingRules(dp=("pod",), fsdp=None, tp=("model", "data"))


# Right-aligned axis-role specs per parameter name. Roles: 'fsdp', 'tp',
# 'ep', None. Names not listed replicate.
_BASE: dict[str, tuple] = {
    # embeddings / heads
    "embed": ("tp", "fsdp"),
    "lm_head": ("fsdp", "tp"),
    # attention
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    # MLA
    "w_dq": ("fsdp", "tp"),
    "w_uq": ("fsdp", "tp"),
    "w_dkv": ("fsdp", "tp"),
    "w_uk": ("fsdp", "tp"),
    "w_uv": ("fsdp", "tp"),
    "w_kr": ("fsdp", None),
    # FFN
    "wi_gate": ("fsdp", "tp"),
    "wi_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # router
    "router": ("fsdp", None),
    # RG-LRU
    "w_gate_branch": ("fsdp", "tp"),
    "w_main": ("fsdp", "tp"),
    "w_input_gate": ("fsdp", "tp"),
    "w_rec_gate": ("fsdp", "tp"),
    "w_out": ("tp", "fsdp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "log_lambda": ("tp",),
    # xLSTM
    "w_up": ("fsdp", "tp"),
    "w_up_gate": ("fsdp", "tp"),
    "w_igate": ("fsdp", None),
    "w_fgate": ("fsdp", None),
    "w_gates": ("fsdp", "tp"),
    "r_gates": (None, None, "tp"),
    "skip_scale": ("tp",),
}

# Names whose leaves live under a 'moe' subtree get an extra leading expert
# dim sharded over ep.
_MOE_BASE: dict[str, tuple] = {
    "wi_gate": ("ep", "fsdp", None),
    "wi_up": ("ep", "fsdp", None),
    "wo": ("ep", None, "fsdp"),
}

_MOE_BASE_EP_ONLY: dict[str, tuple] = {
    "wi_gate": ("ep", None, None),
    "wi_up": ("ep", None, None),
    "wo": ("ep", None, None),
}


def _role_to_axis(role, rules: ShardingRules):
    if role is None:
        return None
    return getattr(rules, role)


def check_unique(spec: tuple) -> tuple:
    """``spec``, if it maps every mesh axis to one dim at most; else
    ``ValueError``, where the reference's ``NamedSharding`` raises
    ``DuplicateSpecError``."""
    seen: set[str] = set()
    for entry in spec:
        for a in entry if isinstance(entry, tuple) else (entry,) if entry else ():
            if a in seen:
                raise ValueError(f"spec {spec} maps mesh axis {a!r} to two dims")
            seen.add(a)
    return spec


def _resolve(roles: tuple, shape: tuple[int, ...], rules: ShardingRules,
             axis_sizes: dict[str, int]) -> tuple:
    """Right-align roles against shape; drop non-dividing axes. Axis
    entries may be tuples (multi-axis sharding, e.g. 2D TP for serving)."""
    ndim = len(shape)
    spec: list = [None] * ndim
    for i, role in enumerate(roles):
        dim = ndim - len(roles) + i
        if dim < 0:
            continue
        axis = _role_to_axis(role, rules)
        if axis is None:
            continue
        parts = axis if isinstance(axis, tuple) else (axis,)
        present = tuple(a for a in parts if a in axis_sizes)
        if not present:
            continue
        size = 1
        for a in present:
            size *= axis_sizes[a]
        if shape[dim] % size != 0:
            continue
        spec[dim] = present if len(present) > 1 else present[0]
    return check_unique(tuple(spec))


def partition_params(params: Any, rules: ShardingRules, mesh=None) -> Any:
    """Spec tree for a parameter tree whose leaves have a ``shape``.

    ``params`` is nested dicts (the reference's layout, e.g.
    ``models.transformer.named_to_tree``, cycle leaves stacked) or a flat
    dict keyed by dotted names (the port's ``named_parameters``, where a
    name's parts are the path). The result has the same keys. Without a
    mesh every spec replicates.
    """
    axis_sizes = mesh.axis_sizes if mesh is not None else {}
    moe_table = _MOE_BASE_EP_ONLY if rules.moe_ep_only else _MOE_BASE

    def leaf_spec(names: list[str], leaf) -> tuple:
        name = names[-1] if names else ""
        in_moe = "moe" in names[:-1]
        table = moe_table if (in_moe and name in moe_table) else _BASE
        roles = table.get(name)
        if roles is None:
            return ()
        return _resolve(roles, tuple(leaf.shape), rules, axis_sizes)

    def walk(tree, names: list[str]):
        if isinstance(tree, dict):
            return {k: walk(v, names + k.split(".")) for k, v in tree.items()}
        return leaf_spec(names, tree)

    return walk(params, [])


def batch_spec(rules: ShardingRules, extra_dims: int = 1) -> tuple:
    """Spec for (B, ...) inputs: batch over dp axes, rest replicated."""
    dp = rules.dp if len(rules.dp) > 1 else rules.dp[0]
    return (dp,) + (None,) * extra_dims


# ---------------------------------------------------------------------------
# Fleet (multi-sensor streaming) carry migration.
# ---------------------------------------------------------------------------

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
