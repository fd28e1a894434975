"""Op-level cost counting: the port's counterpart of ``repro.launch.hlo_analysis``.

The reference parses the optimized post-SPMD HLO of a compiled step and
multiplies each ``while`` body by its trip count. Eager PyTorch compiles
nothing, so there is no HLO: a step is the sequence of aten operators it
dispatches. :class:`OpCounter` is a ``TorchDispatchMode`` that sees each
of them as it runs, on meta, CPU or CUDA tensors alike. It sits below
autograd, so a backward's operators are seen too, and above the backend,
so an operator counts once whatever kernels implement it. It aggregates:

* flops: ``torch.utils.flop_counter``'s formulas, 2 x |result| x the
  contracted size for ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` (which
  ``matmul`` and ``einsum`` lower to), the reference's rule for ``dot``;
  elementwise operators count none, as there;
* bytes: each operator's tensor operands plus its result, the reference's
  rule for an instruction. An operator whose result aliases an input moves
  nothing (a view, ``_unsafe_view``; the counterpart of the reference's
  free bitcasts and converts), and an in-place operator's result is its
  written operand, counted once;
* collective bytes by kind, for the ``_c10d_functional`` collectives, with
  the reference's ring-cost rule: an all-gather its result, an all-reduce
  twice its result, the others their operands. On one card no collective
  runs, so the breakdown is empty;
* ``n_ops``, the operators dispatched (``n_views`` of them moving nothing).

The count is of the port's implementation: per-operator traffic with no
fusion, what each eager kernel reads and writes. It is not the least
traffic of the function (each input byte read once, each output byte
written once) that a roofline share needs.

Loops. The reference counts a scanned body once and multiplies it by its
trip count. The port's layers are a Python loop over an
``nn.ModuleList``, so :func:`count_by_layers` counts the step on a model
of no layers, of one block-pattern cycle and of the remainder layers,
and multiplies the cycle's share by the number of cycles (the second
cycle's share where the first differs): the embedding, the final norm,
the logits, the loss and the optimizer's per-step work are counted once. Within a block, the long Python loops whose iterations
repeat the same operators on the same shapes (``flash_attention``'s chunk
pairs, the sLSTM's steps over time; ``models.common.trips``) run only
their first iteration under ``OpCounter(sampled_loops=True)``, counted
trip-count times, where no autograd graph is being recorded; on meta
tensors that changes no count and no shape.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common

# ``_c10d_functional`` operator (trailing "_" of the in-place form dropped)
# -> the reference's collective kind.
_COLL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# Operators that return their input's storage without an alias annotation.
_FREE = {"aten._unsafe_view", "_c10d_functional.wait_tensor"}
# A kernel's scratch, which does not count: ``log_sigmoid_forward``'s
# ``buffer`` output (the outputs that count are the first n) and the same
# buffer as ``log_sigmoid_backward``'s operand (by position). It is
# full-size on the CPU and the meta device and empty on CUDA.
_COUNTED_OUTPUTS = {"aten.log_sigmoid_forward": 1}
_SCRATCH_OPERAND = {"aten.log_sigmoid_backward": 2}


@dataclasses.dataclass
class OpRecord:
    """One operator at one set of operand shapes: its calls and their
    totals (calls weighted by an enclosing sampled loop's trip count)."""
    calls: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0
    coll_kind: str | None = None
    coll_bytes: float = 0.0
    free: bool = False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Counts the aten operators dispatched inside its ``with`` block.

    ``records`` maps (operator, operand shapes) to an :class:`OpRecord`;
    an operator that takes a list of tensors (the ``_foreach_*`` family,
    ``cat``, ``stack``) is keyed by its name alone. ``sampled_loops``:
    see the module docstring.
    """

    def __init__(self, sampled_loops: bool = False):
        super().__init__()
        self.records: dict[tuple[str, str], OpRecord] = {}
        self.sampled_loops = sampled_loops
        self._mult = 1.0
        self._saved_trips = None

    def __enter__(self):
        if self.sampled_loops:
            self._saved_trips, common.TRIPS = common.TRIPS, self._trips
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self.sampled_loops:
                common.TRIPS = self._saved_trips

    def _trips(self, n: int):
        if n <= 1 or torch.is_grad_enabled():
            return range(n)
        return self._first_trip(n)

    def _first_trip(self, n: int):
        outer = self._mult
        self._mult = outer * n
        try:
            yield 0
        finally:
            self._mult = outer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        name = f"{func.namespace}.{packet.__name__}"
        i = _SCRATCH_OPERAND.get(name)
        ins = _tensors((args if i is None else args[:i] + args[i + 1:], kwargs))
        listed = any(isinstance(a, (list, tuple)) and a and isinstance(a[0], torch.Tensor)
                     for a in (*args, *kwargs.values()))
        shapes = "" if listed else str([tuple(t.shape) for t in ins])
        rec = self.records.setdefault((name, shapes), OpRecord())
        m = self._mult
        rec.calls += m
        returns = func._schema.returns
        view = name in _FREE or any(r.alias_info is not None and not r.alias_info.is_write for r in returns)
        if view:
            rec.free = True
            return
        inplace = any(r.alias_info is not None and r.alias_info.is_write for r in returns)
        moved = sum(_nbytes(t) for t in ins)
        if not inplace:
            outs = out[:_COUNTED_OUTPUTS[name]] if name in _COUNTED_OUTPUTS else out
            moved += sum(_nbytes(t) for t in _tensors(outs))
        rec.bytes += m * moved
        if packet in flop_registry:
            rec.flops += m * flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "_c10d_functional":
            kind = _COLL_KIND.get(packet.__name__.rstrip("_"))
            if kind is not None:
                outs = sum(_nbytes(t) for t in _tensors(out)) or sum(_nbytes(t) for t in ins)
                payload = {"all-gather": outs, "all-reduce": 2 * outs}.get(kind, sum(_nbytes(t) for t in ins))
                rec.coll_kind = kind
                rec.coll_bytes += m * payload


def combine(parts: list[tuple[OpCounter, float]]) -> OpCounter:
    """A counter holding ``sum(coef * counts)`` of the given counters,
    record by record."""
    out = OpCounter()
    for counter, coef in parts:
        for key, r in counter.records.items():
            o = out.records.setdefault(key, OpRecord(coll_kind=r.coll_kind, free=r.free))
            o.calls += coef * r.calls
            o.flops += coef * r.flops
            o.bytes += coef * r.bytes
            o.coll_bytes += coef * r.coll_bytes
    return out


def count(fn: Callable, *args, sampled_loops: bool = False, **kwargs) -> OpCounter:
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`OpCounter`."""
    counter = OpCounter(sampled_loops=sampled_loops)
    with counter:
        fn(*args, **kwargs)
    return counter


def count_by_layers(cfg: ModelConfig, make_step: Callable[[ModelConfig], Callable[[], object]], *,
                    sampled_loops: bool = False) -> OpCounter:
    """The counts of ``make_step(cfg)()`` from steps of fewer layers.

    ``make_step(c)`` builds a step's arguments for the config ``c`` (on the
    meta device, where nothing is allocated) and returns the step as a
    function of no arguments; only the step is counted. With ``n_c`` cycles
    of the block pattern (``P`` layers, a block of each of the pattern's
    types; a cycle is what ``remat`` recomputes) and ``r`` remainder
    layers, and ``C(k)`` the count of the step of ``k`` layers, the count
    is ``C(0) + n_c (C(P) - C(0)) + (C(r) - C(0))``: what does not depend
    on the layers is counted once. Where a train step's first cycle differs
    from the others, it is ``C(P) + (n_c - 1) (C(2P) - C(P)) + (C(P + r) -
    C(P))``: with a frontend's embeddings in, nothing before the first layer
    requires a gradient, so the backward stops at it; with experts, the MoE
    aux loss has a gradient from the first MoE layer on.
    """
    plen = len(cfg.block_pattern)
    n_cycles, rem = divmod(cfg.n_layers, plen)

    def at(n_layers: int) -> OpCounter:
        return count(make_step(dataclasses.replace(cfg, n_layers=n_layers)), sampled_loops=sampled_loops)

    first = plen if (cfg.frontend is not None or cfg.n_experts) and n_cycles else 0
    base = at(first)
    parts = [(base, 1.0)]
    n_more = n_cycles - (1 if first else 0)
    if n_more:
        parts += [(at(first + plen), float(n_more)), (base, -float(n_more))]
    if rem:
        parts += [(at(first + rem), 1.0), (base, -1.0)]
    return combine(parts)


def analyze(counter: OpCounter) -> dict:
    """``{flops, bytes, coll_bytes, coll_breakdown}`` as the reference's
    ``analyze`` returns them, plus ``n_ops`` (operators dispatched) and
    ``n_views`` (those of them that move nothing)."""
    rs = counter.records.values()
    coll: dict[str, float] = {}
    for r in rs:
        if r.coll_kind is not None:
            coll[r.coll_kind] = coll.get(r.coll_kind, 0.0) + r.coll_bytes
    return {
        "flops": float(sum(r.flops for r in rs)),
        "bytes": float(sum(r.bytes for r in rs)),
        "coll_bytes": float(sum(coll.values())),
        "coll_breakdown": {k: float(v) for k, v in sorted(coll.items())},
        "n_ops": float(sum(r.calls for r in rs)),
        "n_views": float(sum(r.calls for r in rs if r.free)),
    }


def _top(counter: OpCounter, field: str, n: int, keep=lambda r: True) -> list[dict]:
    rows = [dict({field: getattr(r, field)}, calls=r.calls, op=op, shapes=shapes, **(
        {"kind": r.coll_kind} if field == "coll_bytes" else {}))
            for (op, shapes), r in counter.records.items() if keep(r) and getattr(r, field) > 0]
    rows.sort(key=lambda d: -d[field])
    return rows[:n]


def top_dots(counter: OpCounter, n: int = 20) -> list[dict]:
    """The N costliest products by FLOPs (all calls at one shape summed)."""
    return _top(counter, "flops", n)


def top_bytes(counter: OpCounter, n: int = 20) -> list[dict]:
    """The N operators that move the most bytes, by operator and shapes."""
    return _top(counter, "bytes", n)


def top_collectives(counter: OpCounter, n: int = 20) -> list[dict]:
    """The N largest collectives by payload bytes."""
    return _top(counter, "coll_bytes", n, keep=lambda r: r.coll_kind is not None)
