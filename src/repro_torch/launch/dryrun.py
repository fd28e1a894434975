"""Dry run: every (arch x shape) cell on the production meshes, with no card.

The port of ``repro.launch.dryrun``. The reference lowers and compiles
each cell for the 16x16 and 2x16x16 TPU meshes and records the compiled
artifact's memory and costs. Eager PyTorch compiles nothing and has no
SPMD partitioner, so each cell here builds its parameters, optimizer
state, decode cache and batch on the meta device (shapes and dtypes; no
card, no allocation, no process group) and records:

* the specs of its arguments under the port's sharding rules
  (:mod:`repro_torch.distributed.sharding`), and from them the per-device
  argument and output bytes (the counterpart of ``memory_analysis()``'s
  ``argument_size_in_bytes`` and ``output_size_in_bytes``);
* the step (train, prefill or decode) counted by
  :mod:`repro_torch.launch.op_analysis` at global shapes, loop-aware
  (``count_by_layers``, long in-block loops sampled);
* the roofline per device as the global count over ``n_devices``: an
  ideal split, where the reference's post-SPMD counts include replicated
  work (:func:`repro_torch.launch.roofline.extract_terms`);
* ``model_flops`` and ``useful_flops_ratio``.

What has no counterpart is ``null``, its reason under ``"nulls"``: the
collective bytes (no partitioner inserts collectives into a step: the
port's collectives are explicit calls over a process group, and an LM step
makes none), temp and peak memory
(nothing is compiled), the lowering and compile times and XLA's raw cost
analysis. The count depends on the cell and the variant, not on the mesh:
a sweep counts each once and reuses it for both meshes.

Importing this module sets nothing in the environment and touches no card.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch

from repro_torch.configs.base import LM_SHAPES, ModelConfig, applicable_shapes, get_config, list_archs
from repro_torch.distributed import sharding as S
from repro_torch.launch import op_analysis as O
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step

DEFAULT_OUT = Path("build/dryrun_results")
META = torch.device("meta")

# The reference's variants that map onto the port (the first five choose
# rules, dtypes and layouts; the last three set the model's module
# switches for the cell), and those that are XLA's alone.
VARIANTS = ("serve_bf16", "cache_seq", "tp2d", "moe_ep_only", "paged", "flash_chunks", "bf16_dots")
XLA_ONLY = {
    "moe_hint": "sharding constraints on the MoE dispatch need an SPMD partitioner, which the port has not",
    "unroll": "it unrolls the scan over decode cycles; the port's layers are a Python loop already",
    "cache_carry": "it carries the stacked cache through the decode scan; the port writes per-layer caches "
                   "in place",
    "flat_cache": "it replaces the scan's stacked cache by per-layer buffers, the port's only layout",
}

NULLS = {
    "coll_bytes_per_device": "no SPMD partitioner inserts collectives; the step makes no explicit one",
    "temp_size_in_bytes": "nothing is compiled, so no buffer is assigned",
    "peak_memory_in_bytes": "nothing is compiled, so no buffer is assigned",
    "t_lower_s": "nothing is lowered",
    "t_compile_s": "nothing is compiled",
    "raw_cost_analysis": "XLA's cost_analysis has no counterpart",
}


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _features(variant: str) -> frozenset:
    features = frozenset(f for f in variant.split(",") if f)
    for f in sorted(features):
        if f in XLA_ONLY:
            raise ValueError(f"variant {f!r} is XLA's alone: {XLA_ONLY[f]}")
        if f not in VARIANTS:
            raise ValueError(f"unknown variant {f!r}; the port takes {', '.join(VARIANTS)}")
    return features


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-device stand-ins for every model input (no allocation)."""
    spec = LM_SHAPES[shape_name]
    b, s = spec.global_batch, spec.seq_len
    s_in = 1 if spec.kind == "decode" else s
    inputs: dict = {}
    if cfg.frontend is not None:
        inputs["embeds"] = _empty((b, s_in, cfg.d_model), torch.bfloat16)
    else:
        inputs["tokens"] = _empty((b, s_in), torch.int32)
    if cfg.pos_kind == "mrope" and spec.kind != "decode":
        inputs["mrope_positions"] = _empty((3, b, s_in), torch.int32)
    return inputs


def _rules(mesh: Mesh, kind: str, features: frozenset = frozenset()) -> S.ShardingRules:
    multi = "pod" in mesh.axis_names
    if kind == "train":
        return S.MULTIPOD_TRAIN_RULES if multi else S.TRAIN_RULES
    if "tp2d" in features:
        return S.MULTIPOD_SERVE_2D_RULES if multi else S.SERVE_2D_RULES
    return S.MULTIPOD_SERVE_RULES if multi else S.SERVE_RULES


def _dp_size(mesh: Mesh, rules: S.ShardingRules) -> int:
    sizes = mesh.axis_sizes
    return math.prod(sizes.get(a, 1) for a in rules.dp)


def _batch_sharding(mesh: Mesh, rules: S.ShardingRules, tree: dict) -> dict:
    """Specs for an input dict: the batch dim over dp, replicated where the
    batch does not divide."""
    dp_size = _dp_size(mesh, rules)
    out = {}
    for name, x in tree.items():
        if name == "mrope_positions":
            spec = (None, rules.dp if len(rules.dp) > 1 else rules.dp[0], None)
        else:
            spec = S.batch_spec(rules, extra_dims=x.ndim - 1)
        bdim = 1 if name == "mrope_positions" else 0
        out[name] = (None,) * x.ndim if x.shape[bdim] % dp_size else spec
    return out


# Cache sharding rules by leaf name (right-aligned, divisibility-checked).
_CACHE_ROLES = {
    "k_page": ("dp", None, None, None),
    "v_page": ("dp", None, None, None),
    "page_pos": (None,),
    "k": ("dp", None, "tp", None),
    "v": ("dp", None, "tp", None),
    "c_kv": ("dp", None, "tp"),
    "k_rope": ("dp", None, None),
    "pos": (None,),
    "h": ("dp", "tp"),
    "conv": ("dp", None, "tp"),
    "c": ("dp", None, None, None),
    "n": ("dp", None, None),
    "m": ("dp", None),
}

# Shard the cache's SEQUENCE dim over the model axis (context parallelism
# for decode). The head-count dim of GQA caches is rarely divisible by 16;
# the 32k sequence always is.
_CACHE_ROLES_SEQ = dict(
    _CACHE_ROLES,
    k=("dp", "tp", None, None),
    v=("dp", "tp", None, None),
    c_kv=("dp", "tp", None),
    k_rope=("dp", "tp", None),
)


def _cache_sharding(mesh: Mesh, rules: S.ShardingRules, cache_tree, roles_table: dict | None = None):
    """Specs for a decode cache (the port's list of per-layer dicts, or the
    reference's stacked tree), by leaf name; a leaf not directly under a
    dict key replicates, as in the reference. A spec that maps an axis to
    two dims (``tp2d`` on the single-pod mesh, where dp and tp both hold
    ``data``) raises ``ValueError``, as the reference's ``NamedSharding``
    does."""
    axis_sizes = mesh.axis_sizes
    table = roles_table or _CACHE_ROLES

    def role_axes(role) -> tuple:
        if role == "dp":
            return tuple(a for a in rules.dp if a in axis_sizes)
        if role == "tp":
            parts = rules.tp if isinstance(rules.tp, tuple) else (rules.tp,)
            return tuple(a for a in parts if a in axis_sizes)
        return ()

    def leaf(name: str, x) -> tuple:
        roles = table.get(name)
        if roles is None:
            return ()
        nd = len(x.shape)
        spec: list = [None] * nd
        for i, role in enumerate(roles):
            dim = nd - len(roles) + i
            if dim < 0 or role is None:
                continue
            axes = role_axes(role)
            total = math.prod(axis_sizes[a] for a in axes)
            if axes and x.shape[dim] % total == 0:
                spec[dim] = axes if len(axes) > 1 else axes[0]
        return S.check_unique(tuple(spec))

    def walk(tree, name: str):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, "") for v in tree]
        return leaf(name, tree)

    return walk(cache_tree, "")


def _served_cache(cache: list, cfg: ModelConfig) -> list:
    """The ``serve_bf16`` cache: float32 leaves of three or more dims in the
    reference's layout (a cycle layer's leaves carry the stacked dim) cast
    to bf16, as the reference casts its stacked cache."""
    n_cycles, _ = T._split_layers(cfg)
    plen = len(cfg.block_pattern)
    out = []
    for li, c in enumerate(cache):
        stacked = 1 if li < n_cycles * plen else 0
        out.append({k: v.to(torch.bfloat16) if v.dtype == torch.float32 and v.ndim + stacked >= 3 else v
                    for k, v in c.items()})
    return out


@dataclasses.dataclass
class Cell:
    """A cell's step on the meta device: its arguments and outputs (full
    size) with their specs, and ``make_step(cfg)``, the step on fresh
    arguments for a config of fewer layers (for ``count_by_layers``)."""
    args: tuple
    in_specs: tuple
    outs: tuple
    out_specs: tuple
    make_step: Callable[[ModelConfig], Callable[[], Any]]


def _cell_args(cfg: ModelConfig, shape_name: str, features: frozenset) -> tuple:
    spec = LM_SHAPES[shape_name]
    b, s = spec.global_batch, spec.seq_len
    # serve_bf16: the served copy's dtypes (bf16, float32 where the model
    # reads float32: norms, router, log_lambda, mLSTM gate biases).
    wdt = torch.bfloat16 if ("serve_bf16" in features and spec.kind != "train") else torch.float32
    model = T.Transformer(cfg, None, device=META, weight_dtype=wdt)
    inputs = input_specs(cfg, shape_name)
    if spec.kind == "train":
        return model, init_opt_state(model), dict(inputs, labels=_empty((b, s), torch.int32))
    if spec.kind == "prefill":
        return model, inputs
    cache = T.init_cache(cfg, b, s, device=META)
    if "serve_bf16" in features:
        cache = _served_cache(cache, cfg)
    return model, inputs, cache, s - 1


@contextlib.contextmanager
def _switches(features: frozenset):
    """The model's module switches for a cell, put back after it."""
    saved = A.CACHE_DTYPE_DOTS, A.Q_CHUNK, A.KV_CHUNK, T.PAGED_DECODE
    A.CACHE_DTYPE_DOTS = "bf16_dots" in features
    A.Q_CHUNK = 1024 if "flash_chunks" in features else 512
    A.KV_CHUNK = 4096 if "flash_chunks" in features else 1024
    T.PAGED_DECODE = 256 if "paged" in features else 0
    try:
        yield
    finally:
        A.CACHE_DTYPE_DOTS, A.Q_CHUNK, A.KV_CHUNK, T.PAGED_DECODE = saved


def build_cell(cfg: ModelConfig, shape_name: str, mesh: Mesh, variant: str = "") -> Cell:
    """The cell's arguments, outputs and their specs on ``mesh``, and its
    step factory. Build and count under :func:`_switches`, as
    :func:`run_cell` does. ``variant`` is a comma-separated list of
    :data:`VARIANTS`; an XLA-only one raises ``ValueError``."""
    features = _features(variant)
    spec = LM_SHAPES[shape_name]
    kind = spec.kind
    rules = _rules(mesh, kind, features)
    if "moe_ep_only" in features:
        rules = dataclasses.replace(rules, moe_ep_only=True)
    cache_roles = _CACHE_ROLES_SEQ if "cache_seq" in features else None
    args = _cell_args(cfg, shape_name, features)
    params = dict(args[0].named_parameters())
    pspecs = S.partition_params(params, rules, mesh)
    b = spec.global_batch
    logits = _empty((b, cfg.vocab), torch.float32)
    lspec = S.batch_spec(rules, extra_dims=1) if b % _dp_size(mesh, rules) == 0 else ()
    if kind == "train":
        _, opt, batch = args
        ospecs = {"step": (), "mu": pspecs, "nu": pspecs}
        metrics = {k: _empty((), torch.float32)
                   for k in ("xent", "accuracy", "moe_aux", "loss", "lr", "grad_norm")}
        in_specs = (pspecs, ospecs, _batch_sharding(mesh, rules, batch))
        outs, out_specs = (params, opt, metrics), (pspecs, ospecs, {k: () for k in metrics})
    elif kind == "prefill":
        # The cache prefill returns: init_cache's layout without a hot page.
        saved, T.PAGED_DECODE = T.PAGED_DECODE, 0
        try:
            cache = T.init_cache(cfg, b, spec.seq_len, device=META)
        finally:
            T.PAGED_DECODE = saved
        in_specs = (pspecs, _batch_sharding(mesh, rules, args[1]))
        outs, out_specs = (logits, cache), (lspec, _cache_sharding(mesh, rules, cache, cache_roles))
    else:
        cspecs = _cache_sharding(mesh, rules, args[2], cache_roles)
        in_specs = (pspecs, _batch_sharding(mesh, rules, args[1]), cspecs, ())
        outs, out_specs = (logits, args[2]), (lspec, cspecs)

    def make_step(c: ModelConfig) -> Callable[[], Any]:
        a = _cell_args(c, shape_name, features)
        if kind == "train":
            step = make_train_step(c, TrainConfig())
            return lambda: step(*a)
        if kind == "prefill":
            return lambda: T.prefill(a[0], a[1], cache_len=spec.seq_len)
        return lambda: T.decode_step(*a)

    return Cell((params,) + args[1:], in_specs, outs, out_specs, make_step)


def per_device_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes a device holds of ``tree`` (tensors in dicts, lists and tuples;
    a host int holds none) laid out by ``specs`` (the same structure, a
    spec a tensor): each tensor's bytes over the product of the sizes of
    the axes its spec names."""
    sizes = mesh.axis_sizes
    if isinstance(tree, dict):
        return sum(per_device_bytes(tree[k], specs[k], mesh) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(per_device_bytes(t, s, mesh) for t, s in zip(tree, specs, strict=True))
    if not isinstance(tree, torch.Tensor):
        return 0
    shards = 1
    for entry in specs:
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            shards *= sizes[a]
    return tree.numel() * tree.element_size() // shards


def count_cell(cfg: ModelConfig, shape_name: str, variant: str = "") -> dict:
    """The cell's step at global shapes, counted by layers with sampled
    loops: :func:`op_analysis.analyze`'s dict. Does not depend on the mesh."""
    features = _features(variant)
    with _switches(features):
        cell = build_cell(cfg, shape_name, make_production_mesh(), variant)
        return O.analyze(O.count_by_layers(cfg, cell.make_step, sampled_loops=True))


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path, variant: str = "",
             counts: dict | None = None) -> dict:
    """Build, specify and count one cell and write its record as JSON
    under ``out_dir``. ``counts`` caches the step's count by (arch, shape,
    variant) across meshes."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = mesh.size
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "variant": variant,
                 "n_devices": n_dev, "ok": False}
    t0 = time.time()
    try:
        key = (arch, shape_name, variant)
        t_count = None
        if counts is None or key not in counts:
            t1 = time.time()
            got = count_cell(cfg, shape_name, variant)
            t_count = time.time() - t1
            if counts is not None:
                counts[key] = got
        else:
            got = counts[key]
        with _switches(_features(variant)):
            cell = build_cell(cfg, shape_name, mesh, variant)
        terms = R.extract_terms(dict(got, coll_bytes=None, coll_breakdown={}), n_dev)
        spec = LM_SHAPES[shape_name]
        tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1)
        mf = R.model_flops(cfg.param_count(), tokens,
                           cfg.active_param_count() if cfg.n_experts else None, kind=spec.kind)
        rec.update(
            ok=True,
            t_lower_s=None,
            t_compile_s=None,
            t_count_s=t_count,
            memory={
                "argument_size_in_bytes": per_device_bytes(cell.args, cell.in_specs, mesh),
                "output_size_in_bytes": per_device_bytes(cell.outs, cell.out_specs, mesh),
                "temp_size_in_bytes": None,
                "peak_memory_in_bytes": None,
            },
            roofline=terms.as_dict(),
            raw_cost_analysis=None,
            counts=got,
            split="ideal: the global count over n_devices",
            model_flops=mf,
            useful_flops_ratio=mf / got["flops"] if got["flops"] else None,
            nulls=NULLS,
        )
    except Exception as e:  # noqa: BLE001 - record and continue, as the reference's sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / _record_name(arch, shape_name, mesh_kind, variant)).write_text(json.dumps(rec, indent=2))
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '')[:120]})"
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {status} ({rec['wall_s']}s)", flush=True)
    return rec


def _record_name(arch: str, shape_name: str, mesh_kind: str, variant: str) -> str:
    suffix = f"__{variant.replace(',', '+')}" if variant else ""
    return f"{arch.replace('/', '_')}__{shape_name}__{mesh_kind}{suffix}.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="")
    args = ap.parse_args(argv)
    _features(args.variant)  # an XLA-only or unknown variant fails before any cell
    out_dir = Path(args.out)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_ok = n_fail = 0
    counts: dict = {}
    t0 = time.time()
    for arch in archs:
        shapes = applicable_shapes(get_config(arch)) if (args.all or args.shape is None) else [args.shape]
        for shape_name in shapes:
            for mesh_kind in meshes:
                fname = out_dir / _record_name(arch, shape_name, mesh_kind, args.variant)
                if args.skip_existing and fname.exists() and json.loads(fname.read_text()).get("ok"):
                    print(f"[dryrun] skip existing OK: {fname.name}")
                    n_ok += 1
                    continue
                rec = run_cell(arch, shape_name, mesh_kind, out_dir, args.variant, counts)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed in {time.time() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
