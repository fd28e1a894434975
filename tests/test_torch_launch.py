"""The port's launch tooling against the JAX reference, on the CPU: the
sharding rules, the op-level cost counter, the H100 roofline and the
meta-device dry run.

Bounds:

* partition, cache and batch specs: equal to the reference's, entry for
  entry (a port spec is the tuple of the reference's ``PartitionSpec``);
* the counter: the reference analyzer's loop case exactly
  (2 x 8 x 64 x 64 x 9 FLOPs); counting by layers, and sampling a loop's
  first iteration, equal to the full count exactly (FLOPs, bytes,
  operators); the FLOPs of a decode step, a prefill and a train step
  (with and without ``remat``) of the tiny preset equal to
  ``analyze(jit(...).lower(...).compile().as_text())["flops"]`` of the
  reference, exactly (measured: equal; within 1% was the aim). Bytes are printed
  side by side and not held: XLA fuses, the port counts eager operators;
* per-device argument bytes on the reference test's (4, 2) mesh: equal to
  ``memory_analysis().argument_size_in_bytes``, except the decode step's
  int32 position, a 4-byte device argument of the reference and a host
  int of the port;
* ``model_flops``: equal.

The decode's ``CACHE_DTYPE_DOTS`` switch is held in
``test_torch_cache_dtype_dots.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as RB
from repro.distributed import sharding as RS
from repro.launch import roofline as RR
from repro.launch import train as RL
from repro.launch.hlo_analysis import analyze as ref_analyze
from repro.models import transformer as RT
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch.configs import base as TB
from repro_torch.distributed import sharding as TS
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import op_analysis as O
from repro_torch.launch import roofline as TR
from repro_torch.launch import train as TL
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from test_torch_lm_models import PORTED, reduce_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
META = torch.device("meta")

RULES = {
    "train": RS.TRAIN_RULES, "serve": RS.SERVE_RULES, "multipod_train": RS.MULTIPOD_TRAIN_RULES,
    "multipod_serve": RS.MULTIPOD_SERVE_RULES, "serve_2d": RS.SERVE_2D_RULES,
    "multipod_serve_2d": RS.MULTIPOD_SERVE_2D_RULES,
    "moe_ep_only": dataclasses.replace(RS.TRAIN_RULES, moe_ep_only=True),
}
PORT_RULES = {
    "train": TS.TRAIN_RULES, "serve": TS.SERVE_RULES, "multipod_train": TS.MULTIPOD_TRAIN_RULES,
    "multipod_serve": TS.MULTIPOD_SERVE_RULES, "serve_2d": TS.SERVE_2D_RULES,
    "multipod_serve_2d": TS.MULTIPOD_SERVE_2D_RULES,
    "moe_ep_only": dataclasses.replace(TS.TRAIN_RULES, moe_ep_only=True),
}
MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}


class _FakeMesh:
    """The reference test's stand-in mesh (``tests/test_sharding_dryrun.py``)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _run(code: str, device_count: int, timeout: int = 600) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={device_count}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _keystr(path) -> str:
    return "".join(f"[{getattr(p, 'key', getattr(p, 'idx', p))!r}]" for p in path)


def _ref_specs(tree) -> dict:
    return {_keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _port_leaves(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (k,)))
        return out
    return {"".join(f"[{k!r}]" for k in path): tree}


def _json(x):
    return json.loads(json.dumps(x))


# ---------------------------------------------------------------------------
# Sharding rules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_partition_specs_match_reference_at_full_width(arch):
    """Every leaf of the full-width parameter tree, both production meshes,
    every rule set: the port's spec is the reference's. The port's per-layer
    named parameters take the stacked leaf's spec without its cycle dim."""
    rcfg, tcfg = RB.get_config(arch), TB.get_config(arch)
    ref_tree = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rcfg))
    named = dict(TT.Transformer(tcfg, None, device=META).named_parameters())
    port_tree = TT.named_to_tree(named, tcfg)
    n_cycles, _ = TT._split_layers(tcfg)
    plen = len(tcfg.block_pattern)
    for mesh_kind, (shape, axes) in MESHES.items():
        for name, rules in RULES.items():
            want = _ref_specs(RS.partition_params(ref_tree, rules, _FakeMesh(shape, axes)))
            mesh = TMESH.Mesh(shape, axes)
            got = _port_leaves(TS.partition_params(port_tree, PORT_RULES[name], mesh))
            assert got == want, (mesh_kind, name)
            # The port's own layout: per-layer names, no stacked dim.
            per_layer = TS.partition_params(named, PORT_RULES[name], mesh)
            for key, spec in per_layer.items():
                if key.startswith("layers."):
                    li, rest = key.split(".", 2)[1:]
                    li = int(li)
                    src = "['cycles']" + "".join(
                        f"['{p}']" for p in [f"blk{li % plen}", *rest.split(".")]) if li < n_cycles * plen \
                        else "".join(f"['{p}']" for p in [f"rem{li - n_cycles * plen}", *rest.split(".")])
                    stacked = want[src]
                    assert spec == (stacked[1:] if stacked and li < n_cycles * plen else stacked), key
                else:
                    assert spec == want[f"['{key}']"], key


def test_partition_params_rules():
    """The reference's ``test_partition_params_rules``, against the port."""
    tree = {
        "embed": torch.empty(50304, 2560, device=META),
        "cycles": {"blk0": {
            "inner": {"wq": torch.empty(16, 2560, 2560, device=META)},
            "moe": {"wi_gate": torch.empty(16, 64, 2048, 1408, device=META)},
            "norm1": torch.empty(16, 2560, device=META),
        }},
    }
    specs = TS.partition_params(tree, TS.TRAIN_RULES, TMESH.Mesh((16, 16), ("data", "model")))
    assert specs["embed"] == ("model", "data") == tuple(P("model", "data"))
    assert specs["cycles"]["blk0"]["inner"]["wq"] == (None, "data", "model")
    assert specs["cycles"]["blk0"]["moe"]["wi_gate"] == (None, "model", "data", None)
    assert specs["cycles"]["blk0"]["norm1"] == () == tuple(P())


def test_partition_divisibility_fallback():
    mesh = TMESH.Mesh((16, 16), ("data", "model"))
    specs = TS.partition_params({"embed": torch.empty(73448, 2560, device=META)}, TS.TRAIN_RULES, mesh)
    assert specs["embed"] == (None, "data")
    ref = RS.partition_params({"embed": jax.ShapeDtypeStruct((73448, 2560), jnp.float32)}, RS.TRAIN_RULES,
                              _FakeMesh((16, 16), ("data", "model")))
    assert specs["embed"] == tuple(ref["embed"])


def test_serve_rules_no_fsdp():
    mesh = TMESH.Mesh((16, 16), ("data", "model"))
    params = {"wq": torch.empty(2048, 2048, device=META)}
    assert TS.partition_params(params, TS.SERVE_RULES, mesh)["wq"] == (None, "model")
    assert TS.partition_params(params, TS.TRAIN_RULES, mesh)["wq"] == ("data", "model")
    assert TS.partition_params(params, TS.TRAIN_RULES)["wq"] == (None, None)  # no mesh: replicated
    assert TS.batch_spec(TS.MULTIPOD_TRAIN_RULES, 2) == tuple(RS.batch_spec(RS.MULTIPOD_TRAIN_RULES, 2))
    assert TS.batch_spec(TS.SERVE_RULES) == tuple(RS.batch_spec(RS.SERVE_RULES)) == ("data", None)


_CACHE_VARIANTS = ("", "cache_seq", "tp2d")


def test_cache_and_batch_specs_match_reference():
    """``_cache_sharding`` and ``_batch_sharding`` of every architecture's
    cells on both production meshes, with and without ``cache_seq`` (and
    ``tp2d``), against the reference's on the 512-device host mesh (traced
    only). The port's per-layer cache takes the stacked leaf's spec
    without its cycle dim. Where ``tp2d`` maps ``data`` to two dims of a
    cache leaf on the single-pod mesh, the reference's ``NamedSharding``
    raises and so does the port."""
    code = f"""
import json, jax
from repro.launch import dryrun as D
from repro.configs.base import LM_SHAPES, applicable_shapes, get_config, list_archs
from repro.launch.mesh import make_production_mesh
from repro.models.transformer import init_cache
def ks(path):
    return "".join(f"[{{p.key!r}}]" for p in path)
out = {{}}
for mk in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mk == "multi")
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            spec = LM_SHAPES[shape]
            cache = None
            for variant in {_CACHE_VARIANTS!r}:
                feats = frozenset(f for f in variant.split(",") if f)
                rules = D._rules(mesh, spec.kind, feats)
                rec = {{"batch": {{k: list(v.spec) for k, v in
                                  D._batch_sharding(mesh, rules, D.input_specs(cfg, shape)).items()}}}}
                if spec.kind == "decode":
                    cache = cache or jax.eval_shape(lambda: init_cache(cfg, spec.global_batch, spec.seq_len))
                    roles = D._CACHE_ROLES_SEQ if variant == "cache_seq" else None
                    try:
                        cs = D._cache_sharding(mesh, rules, cache, roles)
                    except Exception as e:  # a spec naming an axis twice
                        rec["cache"] = type(e).__name__
                    else:
                        rec["cache"] = {{ks(p): list(s.spec)
                                         for p, s in jax.tree_util.tree_flatten_with_path(cs)[0]}}
                out[f"{{mk}}|{{arch}}|{{shape}}|{{variant}}"] = rec
print(json.dumps(out))
"""
    want = json.loads(_run(code, 512).strip().splitlines()[-1])
    n_checked = n_raised = 0
    for mk in MESHES:
        mesh = TMESH.make_production_mesh(multi_pod=mk == "multi")
        for arch in TB.list_archs():
            cfg = TB.get_config(arch)
            n_cycles, _ = TT._split_layers(cfg)
            plen = len(cfg.block_pattern)
            for shape in TB.applicable_shapes(cfg):
                spec = TB.LM_SHAPES[shape]
                for variant in _CACHE_VARIANTS:
                    w = want[f"{mk}|{arch}|{shape}|{variant}"]
                    rules = D._rules(mesh, spec.kind, D._features(variant))
                    got = D._batch_sharding(mesh, rules, D.input_specs(cfg, shape))
                    assert _json(got) == w["batch"], (mk, arch, shape, variant)
                    if spec.kind != "decode":
                        continue
                    cache = TT.init_cache(cfg, spec.global_batch, spec.seq_len, device=META)
                    roles = D._CACHE_ROLES_SEQ if variant == "cache_seq" else None
                    if w["cache"] == "DuplicateSpecError":
                        with pytest.raises(ValueError, match="two dims"):
                            D._cache_sharding(mesh, rules, cache, roles)
                        n_raised += 1
                        continue
                    stacked = _port_leaves(D._cache_sharding(mesh, rules, TT._to_reference_tree(cache, cfg), roles))
                    assert _json(stacked) == w["cache"], (mk, arch, shape, variant)
                    for li, layer in enumerate(D._cache_sharding(mesh, rules, cache, roles)):
                        name, cyc = TT._layer_source(cfg, li)
                        for k, s in layer.items():
                            ws = w["cache"][("['cycles']" if cyc is not None else "") + f"['{name}']['{k}']"]
                            assert _json(list(s)) == (ws[1:] if cyc is not None and ws else ws), (arch, li, k)
                            n_checked += 1
    assert n_checked > 1000 and n_raised > 0


# ---------------------------------------------------------------------------
# The op counter.
# ---------------------------------------------------------------------------

def test_counter_loop_case_as_the_reference_analyzer():
    """``tanh(c @ w)`` nine times: the reference's
    ``test_analyzer_on_real_compiled_module``, exactly, as a plain loop and
    as a marked loop sampled once (no autograd)."""
    from repro_torch.models.common import trips

    def f(w, x, marked):
        c = x
        for _ in (trips(9) if marked else range(9)):
            c = torch.tanh(c @ w)
        return c.sum()

    w, x = torch.randn(64, 64), torch.randn(8, 64)
    expect = 2 * 8 * 64 * 64 * 9
    full = O.analyze(O.count(f, w, x, False))
    assert full["flops"] == expect
    with torch.no_grad():
        sampled = O.analyze(O.count(f, w, x, True, sampled_loops=True))
    assert sampled == full
    assert full["bytes"] == 9 * ((8 * 64 + 64 * 64 + 8 * 64) + 2 * 8 * 64) * 4 + (8 * 64 + 1) * 4
    assert full["n_ops"] == 19 and full["n_views"] == 0 and full["coll_bytes"] == 0
    top = O.top_dots(O.count(f, w, x, False))
    assert top == [dict(flops=float(expect), calls=9.0, op="aten.mm", shapes="[(8, 64), (64, 64)]")]


def test_counter_views_inplace_and_lists():
    """A view moves nothing; an in-place operator's result is its written
    operand, counted once; a list operator is keyed by its name."""
    a = torch.zeros(4, 8)
    c = O.count(lambda: (a.t(), a.view(32), a.add_(1.0), torch._foreach_mul_([a, a], 2.0),
                         torch.cat([a, a])))
    out = O.analyze(c)
    assert out["n_ops"] == 5 and out["n_views"] == 2
    assert out["bytes"] == 128 + 256 + (256 + 256)
    assert ("aten._foreach_mul_", "") in c.records and ("aten.cat", "") in c.records


def test_counter_skips_a_kernels_scratch():
    """``log_sigmoid_forward``'s ``buffer`` (full-size on the CPU and the
    meta device, empty on CUDA) counts neither as its output nor as
    ``log_sigmoid_backward``'s operand, so a count does not depend on the
    device."""
    x = torch.randn(2, 3, requires_grad=True)
    c = O.count(lambda: torch.autograd.grad(torch.nn.functional.logsigmoid(x).sum(), x))
    assert c.records[("aten.log_sigmoid_forward", "[(2, 3)]")].bytes == 2 * 24
    assert c.records[("aten.log_sigmoid_backward", "[(2, 3), (2, 3)]")].bytes == 3 * 24


def test_counter_counts_collectives_by_kind(tmp_path):
    """The ``_c10d_functional`` collectives, on a one-process gloo group:
    all-reduce twice its result, all-gather its result, as the reference's
    ring rule; ``wait_tensor`` moves nothing."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        x, name = torch.ones(16), dist.group.WORLD.group_name
        f = torch.ops._c10d_functional
        c = O.count(lambda: (f.wait_tensor(f.all_reduce(x, "sum", name)),
                             f.wait_tensor(f.all_gather_into_tensor(x, 1, name))))
    finally:
        dist.destroy_process_group()
    out = O.analyze(c)
    assert out["coll_breakdown"] == {"all-gather": 64.0, "all-reduce": 128.0}
    assert out["coll_bytes"] == 192.0
    assert [d["kind"] for d in O.top_collectives(c)] == ["all-reduce", "all-gather"]


def _layered_cfg(arch: str):
    """reduce_cfg with two block-pattern cycles and a remainder layer."""
    cfg = reduce_cfg(TB.get_config(arch))
    plen = len(cfg.block_pattern)
    return dataclasses.replace(cfg, n_layers=2 * plen + 1)


def _meta_step(kind: str, b: int = 2, s: int = 12, remat: bool = True):
    def make(cfg):
        model = TT.Transformer(cfg, None, device=META)
        name = "embeds" if cfg.frontend else "tokens"
        inputs = {name: torch.empty((b, s, cfg.d_model) if cfg.frontend else (b, s),
                                    dtype=torch.float32 if cfg.frontend else torch.int32, device=META)}
        if kind == "train":
            step = TTS.make_train_step(cfg, TTS.TrainConfig(remat=remat))
            batch = dict(inputs, labels=torch.empty(b, s, dtype=torch.int32, device=META))
            opt = TO.init_opt_state(model)
            return lambda: step(model, opt, batch)
        if kind == "prefill":
            return lambda: TT.prefill(model, inputs, cache_len=s + 4)
        cache = TT.init_cache(cfg, b, s + 4, device=META)
        one = {k: v[:, :1] for k, v in inputs.items()}
        return lambda: TT.decode_step(model, one, cache, s)

    return make


@pytest.mark.parametrize("arch", PORTED)
def test_count_by_layers_equals_the_full_count(arch):
    """One cycle of each block type (and the remainder) counted and
    multiplied equals the whole step counted, exactly: train (with remat),
    prefill and decode."""
    cfg = _layered_cfg(arch)
    for kind in ("train", "prefill", "decode"):
        make = _meta_step(kind)
        full = O.analyze(O.count(make(cfg)))
        by_layers = O.analyze(O.count_by_layers(cfg, make))
        assert by_layers == full, (kind, by_layers, full)
        assert full["flops"] > 0


@pytest.mark.parametrize("arch,s", [("llama3.2-1b", 13), ("recurrentgemma-9b", 16), ("xlstm-350m", 13)])
def test_sampled_loops_equal_the_full_count(arch, s, monkeypatch):
    """flash_attention's chunk pairs (padded, 4 x 8-wide chunks) and the
    sLSTM's steps run once under ``sampled_loops`` in a prefill: the same
    FLOPs, bytes and operators as every iteration run. A train step records
    a graph, so its loops run in full."""
    monkeypatch.setattr(TA, "Q_CHUNK", 4)
    monkeypatch.setattr(TA, "KV_CHUNK", 8)
    cfg = _layered_cfg(arch)
    for kind in ("prefill", "train"):
        make = _meta_step(kind, s=s)
        full = O.analyze(O.count(make(cfg)))
        sampled = O.analyze(O.count(make(cfg), sampled_loops=True))
        assert sampled == full, kind


def _tiny():
    return RL.reduced_config("llama3.2-1b", "tiny"), TL.reduced_config("llama3.2-1b", "tiny")


@pytest.mark.parametrize("kind", ["decode", "prefill", "train", "train_remat"])
def test_counter_flops_match_reference_hlo_at_tiny_preset(kind):
    """The port's op count of a step against the reference analyzer on the
    compiled HLO of the same step, the tiny preset, batch 4 x 64: FLOPs
    equal (both count only the products; remat's second forward is in
    both). Bytes printed side by side, not held."""
    rcfg, tcfg = _tiny()
    b, s = 4, 64
    sds = jax.ShapeDtypeStruct
    params = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rcfg))
    model = TT.Transformer(tcfg, None, device=META)
    toks = torch.empty(b, s, dtype=torch.int32, device=META)
    if kind == "decode":
        cache = jax.eval_shape(lambda: RT.init_cache(rcfg, b, s))
        fn, args = (lambda p, i, c, pos: RT.decode_step(p, i, c, pos, rcfg)), (
            params, {"tokens": sds((b, 1), jnp.int32)}, cache, sds((), jnp.int32))
        got = O.count(TT.decode_step, model, {"tokens": toks[:, :1]}, TT.init_cache(tcfg, b, s, device=META), s - 1)
    elif kind == "prefill":
        fn, args = (lambda p, i: RT.prefill(p, i, rcfg, cache_len=s)), (params, {"tokens": sds((b, s), jnp.int32)})
        got = O.count(TT.prefill, model, {"tokens": toks}, cache_len=s)
    else:
        remat = kind == "train_remat"
        batch = {"tokens": sds((b, s), jnp.int32), "labels": sds((b, s), jnp.int32)}
        fn = RTS.make_train_step(rcfg, RTS.TrainConfig(remat=remat))
        args = (params, jax.eval_shape(RO.init_opt_state, params), batch)
        step = TTS.make_train_step(tcfg, TTS.TrainConfig(remat=remat))
        got = O.count(step, model, TO.init_opt_state(model), {"tokens": toks, "labels": toks})
    want = ref_analyze(jax.jit(fn).lower(*args).compile().as_text())
    got = O.analyze(got)
    print(f"\n[{kind}] FLOPs port {got['flops']:.6e} reference {want['flops']:.6e}; bytes port "
          f"{got['bytes']:.6e} reference {want['bytes']:.6e}; port aten ops {got['n_ops']:.0f}")
    assert got["flops"] == want["flops"]
    assert got["coll_bytes"] == want["coll_bytes"] == 0


def test_per_device_argument_bytes_match_reference_memory_analysis():
    """The reference test's (4, 2) mesh and config (``test_dryrun_small_mesh``):
    the dry run's per-device argument bytes of the train step (TRAIN_RULES,
    batch 8 x 64) and the decode step (SERVE_RULES, cache 8 x 128) against
    ``compiled.memory_analysis().argument_size_in_bytes``: equal, the decode
    step's reference adding its 4-byte int32 position."""
    small = dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=512, vocab=1024, head_dim=32)
    code = f"""
import dataclasses, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.distributed import sharding as S
from repro.launch.mesh import make_mesh, use_mesh
from repro.launch.dryrun import _batch_sharding, _cache_sharding
from repro.models.transformer import init_params, init_cache, decode_step
from repro.train.optimizer import init_opt_state
from repro.train.train_step import TrainConfig, make_train_step
cfg = dataclasses.replace(get_config("llama3.2-1b"), **{small!r})
mesh = make_mesh((4, 2), ("data", "model"))
params_sds = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
with use_mesh(mesh):
    rules = S.TRAIN_RULES
    pshard = jax.tree.map(lambda s: NamedSharding(mesh, s), S.partition_params(params_sds, rules, mesh))
    batch = {{"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32), "labels": jax.ShapeDtypeStruct((8, 64), jnp.int32)}}
    oshard = {{"step": NamedSharding(mesh, P()), "mu": pshard, "nu": pshard}}
    train = jax.jit(make_train_step(cfg, TrainConfig()), in_shardings=(pshard, oshard, _batch_sharding(mesh, rules, batch))
                    ).lower(params_sds, jax.eval_shape(init_opt_state, params_sds), batch).compile()
    cache_sds = jax.eval_shape(lambda: init_cache(cfg, 8, 128))
    pshard = jax.tree.map(lambda s: NamedSharding(mesh, s), S.partition_params(params_sds, S.SERVE_RULES, mesh))
    inp = {{"tokens": jax.ShapeDtypeStruct((8, 1), jnp.int32)}}
    decode = jax.jit(partial(decode_step, cfg=cfg), in_shardings=(
        pshard, _batch_sharding(mesh, S.SERVE_RULES, inp), _cache_sharding(mesh, S.SERVE_RULES, cache_sds),
        NamedSharding(mesh, P()))).lower(params_sds, inp, cache_sds, jax.ShapeDtypeStruct((), jnp.int32)).compile()
print(train.memory_analysis().argument_size_in_bytes, decode.memory_analysis().argument_size_in_bytes)
"""
    want_train, want_decode = map(int, _run(code, 8).split()[-2:])
    cfg = dataclasses.replace(TB.get_config("llama3.2-1b"), **small)
    mesh = TMESH.Mesh((4, 2), ("data", "model"))
    model = TT.Transformer(cfg, None, device=META)
    params = dict(model.named_parameters())
    pspecs = TS.partition_params(params, TS.TRAIN_RULES, mesh)
    batch = {"tokens": torch.empty(8, 64, dtype=torch.int32, device=META), "labels": torch.empty(8, 64, dtype=torch.int32,
                                                                                               device=META)}
    train = D.per_device_bytes((params, TO.init_opt_state(model), batch),
                               (pspecs, {"step": (), "mu": pspecs, "nu": pspecs},
                                D._batch_sharding(mesh, TS.TRAIN_RULES, batch)), mesh)
    cache = TT.init_cache(cfg, 8, 128, device=META)
    inp = {"tokens": torch.empty(8, 1, dtype=torch.int32, device=META)}
    decode = D.per_device_bytes((params, inp, cache, 127), (
        TS.partition_params(params, TS.SERVE_RULES, mesh), D._batch_sharding(mesh, TS.SERVE_RULES, inp),
        D._cache_sharding(mesh, TS.SERVE_RULES, cache), ()), mesh)
    assert train == want_train
    assert decode + 4 == want_decode


def test_model_flops_and_roofline_terms():
    for args in ((1_235_814_400, 8 * 128), (2_000, 7, 500), (2_000, 7, None, "decode")):
        assert TR.model_flops(*args) == RR.model_flops(*args)
    assert TMESH.PEAK_FLOPS_BF16 == 989e12 and TMESH.HBM_BW == 3.35e12 and TMESH.LINK_BW == 450e9
    t = TR.extract_terms({"flops": 989e12 * 4, "bytes": 3.35e12, "coll_bytes": None, "coll_breakdown": {}}, 4)
    ref_keys = set(RR.RooflineTerms(1.0, 1.0, 1.0, 1).as_dict())
    assert set(t.as_dict()) == ref_keys
    assert t.t_compute == pytest.approx(1.0) and t.t_memory == pytest.approx(0.25)
    assert t.t_collective is None and t.bottleneck == "compute" and t.t_bound == pytest.approx(1.0)
    t = TR.RooflineTerms(0.0, 0.0, 450e9, 1)
    assert t.bottleneck == "collective" and t.t_bound == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# The meta device.
# ---------------------------------------------------------------------------

def test_weak_scalar_rounds_as_torch_and_dispatches_nothing():
    """The MLA decode's weakly typed constants: rounded as
    ``torch.tensor(value, dtype)`` rounds them, with no operator for the
    counter to see (a count must not depend on what ran before it)."""
    from repro_torch.models.common import weak_scalar

    rng = np.random.default_rng(0)
    vals = [*(rng.standard_normal(4000) * rng.choice([1e-3, 1.0, 1e3, 1e30], 4000)), 48 ** 0.5, 48 ** -0.5, 1e-40]
    c = O.OpCounter()
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        with c:
            got = [weak_scalar(float(v), dt) for v in vals]
        assert got == [torch.tensor(float(v), dtype=dt).item() for v in vals], dt
    assert c.records == {}


def test_meta_device_builds_and_runs_every_step():
    """init_params, init_cache and init_opt_state on the meta device, and a
    train step there: no generator, no allocation, nothing read back."""
    cfg = TB.get_config("deepseek-67b")
    model = TT.init_params(0, cfg, device="meta")
    assert model.device.type == "meta" and all(p.is_meta for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) > 6e10
    assert all(v.is_meta for c in TT.init_cache(cfg, 2, 8, device="meta") for v in c.values())
    small = reduce_cfg(TB.get_config("llama3.2-1b"))
    m = TT.init_params(0, small, device="meta")
    opt = TO.init_opt_state(m)
    batch = {k: torch.empty(2, 8, dtype=torch.int32, device=META) for k in ("tokens", "labels")}
    m, opt, metrics = TTS.make_train_step(small, TTS.TrainConfig())(m, opt, batch)
    assert opt["step"].is_meta and all(v.is_meta for v in metrics.values())


# ---------------------------------------------------------------------------
# The dry run.
# ---------------------------------------------------------------------------

REF_RECORD_KEYS = {"arch", "shape", "mesh", "variant", "n_devices", "ok", "t_lower_s", "t_compile_s", "memory",
                   "roofline", "raw_cost_analysis", "model_flops", "useful_flops_ratio", "wall_s"}
REF_MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "peak_memory_in_bytes"}


def _reduced_registry(monkeypatch):
    monkeypatch.setattr(D, "get_config", lambda arch: reduce_cfg(TB.get_config(arch)))


@pytest.mark.parametrize("arch,shapes", [
    ("llama3.2-1b", ("train_4k", "prefill_32k", "decode_32k")),
    # xLSTM's train_4k counts 4,096 sLSTM steps with their backward in full
    # (about 3 minutes); its prefill samples them.
    ("xlstm-350m", ("prefill_32k", "decode_32k", "long_500k"))])
def test_dryrun_cell_of_each_kind_on_a_reduced_config(arch, shapes, tmp_path, monkeypatch):
    """train_4k, prefill_32k and decode_32k of a reduced config on both
    meshes: every record ok, with the reference's keys, the count shared by
    the two meshes, the roofline an ideal split, the nulls named, and the
    model's module switches put back."""
    _reduced_registry(monkeypatch)
    counts: dict = {}
    for shape in shapes:
        recs = [D.run_cell(arch, shape, mk, tmp_path, counts=counts) for mk in ("single", "multi")]
        for rec in recs:
            assert rec["ok"], rec.get("traceback")
            assert REF_RECORD_KEYS <= set(rec) and set(rec["memory"]) == REF_MEMORY_KEYS
            assert set(rec["roofline"]) == set(RR.RooflineTerms(1.0, 1.0, 1.0, 1).as_dict())
            assert rec["roofline"]["coll_bytes_per_device"] is None and rec["memory"]["peak_memory_in_bytes"] is None
            assert set(rec["nulls"]) >= {"coll_bytes_per_device", "temp_size_in_bytes", "peak_memory_in_bytes"}
            n = rec["n_devices"]
            assert rec["roofline"]["flops_per_device"] * n == pytest.approx(rec["counts"]["flops"])
            assert 0 < rec["useful_flops_ratio"] < 1.5
            assert json.loads((tmp_path / D._record_name(arch, shape, rec["mesh"], "")).read_text()) == _json(rec)
        single, multi = recs
        assert single["counts"] == multi["counts"] and single["t_count_s"] is not None and multi["t_count_s"] is None
        assert multi["memory"]["argument_size_in_bytes"] <= single["memory"]["argument_size_in_bytes"]
    assert (TA.CACHE_DTYPE_DOTS, TA.Q_CHUNK, TA.KV_CHUNK, TT.PAGED_DECODE) == (False, 512, 1024, 0)


def test_dryrun_variants(tmp_path, monkeypatch):
    """The variants that map onto the port change what they should; the
    XLA-only ones raise ValueError with the reason, in ``build_cell`` and
    in ``main`` before any cell."""
    _reduced_registry(monkeypatch)
    cfg = dataclasses.replace(reduce_cfg(TB.get_config("llama3.2-1b")), dtype="bfloat16")
    mesh = TMESH.make_production_mesh()
    base = D.count_cell(cfg, "decode_32k")
    assert D.count_cell(cfg, "decode_32k", "bf16_dots")["bytes"] < base["bytes"]
    assert D.count_cell(cfg, "decode_32k", "paged")["n_ops"] > base["n_ops"]
    assert D.count_cell(cfg, "prefill_32k", "flash_chunks")["n_ops"] < D.count_cell(cfg, "prefill_32k")["n_ops"]
    plain = D.build_cell(cfg, "decode_32k", mesh)
    seq = D.build_cell(cfg, "decode_32k", mesh, "cache_seq,serve_bf16")
    assert seq.in_specs[2][0]["k"] == ("data", "model", None, None) != plain.in_specs[2][0]["k"]
    assert D.per_device_bytes(seq.args[0], seq.in_specs[0], mesh) < D.per_device_bytes(plain.args[0],
                                                                                        plain.in_specs[0], mesh)
    for variant in D.XLA_ONLY:
        with pytest.raises(ValueError, match="XLA"):
            D.build_cell(cfg, "decode_32k", mesh, variant)
        with pytest.raises(ValueError, match="XLA"):
            D.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--variant", variant, "--out", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []
    assert D.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh", "both", "--variant", "tp2d",
                   "--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "llama3.2-1b__decode_32k__multi__tp2d.json", "llama3.2-1b__decode_32k__single__tp2d.json"]
