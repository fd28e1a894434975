"""The port's multi-device slice in one process, on the CPU: meshes of
``torch.device("cpu", i)`` entries stand in for the reference's forced
host devices (``--xla_force_host_platform_device_count``).

The reference's mesh cases, each against the reference run here on its
single device (its own tests show that its sharded and unsharded runs
agree):

* ``tests/test_fleet.py::test_fleet_sensor_sharded_carries`` and
  ``::test_fleet_grow_resharding`` — a 4-sensor fleet on a 4-entry
  ``sensor`` mesh reports spec ``("sensor",)`` for its carry and equals
  the reference's fleet; a 2-slot pool there is replicated (``()``) and
  shards once grown to 4, its live sensors unchanged;
* ``tests/test_carry_migration.py::test_grow_migrate_shrink_four_devices``
  — grow, migrate, shrink and permute across a 4- and a 2-entry mesh,
  every step against the numpy oracle, the same random sequence as the
  reference's;
* ``tests/test_constellation.py::test_constellation_multidevice`` — 2
  shards of 2 devices each with a migration, every session against its
  dedicated stream, and the exchange's compression ratio over 3;
* ``tests/test_train_infra.py::test_checkpoint_elastic_restore_resharded``
  — ``restore(shardings=)`` onto a (4, 2) ("data", "model") mesh;
* ``sharded_batches``, ``shard_map`` (the node array of
  ``examples/multi_node_array.py``) and the host view of a sparsely
  occupied pool, with and without a mesh.

Integers and booleans are held exactly; floats across the packages to
the fleet tests' bounds (metrics rtol = atol = 1e-5, tracker floats rtol
1e-6, atol 1e-4); the port's sharded runs equal its unsharded ones to the
bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core.events import EventBatch as JEventBatch
from repro.core.grid_clustering import GridConfig as JGridConfig
from repro.core.grid_clustering import grid_cluster as j_grid_cluster
from repro.data import lm_data as JLM
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.core import pipeline as TP
from repro_torch.core.events import EventBatch
from repro_torch.core.grid_clustering import GridConfig, grid_cluster
from repro_torch.core.pipeline.fleet import FleetPipeline
from repro_torch.data import lm_data as TLM
from repro_torch.data.synthetic import make_recording
from repro_torch.distributed import sharding as TS
from repro_torch.launch.mesh import Mesh, make_mesh, shard_map, use_mesh
from repro_torch.serve.chaos import _FakeClock, _Stream, compare_outputs, concat_outputs
from repro_torch.serve.constellation import ConstellationService
from repro_torch.train.checkpoint import CheckpointManager
from test_torch_constellation import CONFIG as CONST_CONFIG
from test_torch_constellation import MANUAL, _dedicated, _drain_all, _make
from test_torch_serve_service import _assert_same, _surfaces
from test_torch_stream import _close_to_reference

torch.set_num_threads(1)

SENSOR = ("sensor",)


def cpu_mesh(shape, axes=SENSOR):
    n = int(np.prod(shape))
    return make_mesh(shape, axes, devices=[torch.device("cpu", i) for i in range(n)])


def _recordings(duration_s: float):
    return [make_recording(seed=20 + s, duration_s=duration_s, n_rsos=1) for s in range(4)]


def _chunks(recs):
    return [(r.x, r.y, r.t, r.p) for r in recs]


def _carry_specs(fp) -> set:
    return {fp.state.atlas.spec} | {a.spec for a in fp.state.tracks}


def _stacked_equal(a, b) -> None:
    """Two fleet rounds' stacked outputs equal to the bit (tensors or
    ``Placed`` leaves)."""
    np.testing.assert_array_equal(a.n_windows, b.n_windows)
    assert (a.clusters is None) == (b.clusters is None)
    for group in ("clusters", "tracks", "final_tracks"):
        x, y = getattr(a, group), getattr(b, group)
        if x is None:
            assert y is None
            continue
        for f, u, v in zip(x._fields, x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=f"{group}.{f}")
    if a.metrics is not None:
        for k in a.metrics:
            np.testing.assert_array_equal(np.asarray(a.metrics[k]), np.asarray(b.metrics[k]), err_msg=k)


def _against_reference(got, want, slots) -> None:
    for s in slots:
        g, w = got.sensor(s), want.sensor(s)
        if g.num_windows:
            _close_to_reference([g], [w])
        for f in ("hits", "misses", "age", "active"):
            np.testing.assert_array_equal(np.asarray(getattr(g.final_tracks, f)),
                                          np.asarray(getattr(w.final_tracks, f)), err_msg=f)
        for f in ("x", "y", "vx", "vy", "entropy"):
            np.testing.assert_allclose(np.asarray(getattr(g.final_tracks, f)),
                                       np.asarray(getattr(w.final_tracks, f)),
                                       rtol=1e-6, atol=1e-4, err_msg=f)


# ---------------------------------------------------------------------------
# The fleet on a sensor mesh.
# ---------------------------------------------------------------------------


def test_fleet_sensor_sharded_carries_equal_reference():
    """4 sensors over a 4-entry mesh: the carry and the round's outputs
    are sensor-sharded, each leaf one block an entry, and every round
    equals the unsharded port fleet to the bit and the reference's fleet
    to the stated bounds; the atlas equals the reference's exactly."""
    mesh = cpu_mesh((4,))
    chunks = _chunks(_recordings(0.2))
    plain = FleetPipeline(TP.PipelineConfig(), n_sensors=4, device="cpu")
    sharded = FleetPipeline(TP.PipelineConfig(), n_sensors=4, mesh=mesh)
    ref = JP.FleetPipeline(JP.PipelineConfig(), n_sensors=4)
    assert _carry_specs(sharded) == {SENSOR}
    blocks = TS.sensor_blocks(sharded.state.atlas)
    assert [(lo, hi, mesh.device_at(c)) for lo, hi, c, _ in blocks] == [
        (s, s + 1, torch.device("cpu", s)) for s in range(4)]
    for feed in (lambda fp: fp.feed(chunks), lambda fp: fp.flush()):
        a, b, j = feed(plain), feed(sharded), feed(ref)
        assert b.clusters.count.spec == SENSOR and b.final_tracks.x.spec == SENSOR
        _stacked_equal(a, b)
        np.testing.assert_array_equal(np.asarray(b.clusters.count), np.asarray(j.clusters.count))
        _against_reference(b, j, range(4))
    assert _carry_specs(sharded) == {SENSOR}
    np.testing.assert_array_equal(np.asarray(sharded.state.atlas), np.asarray(ref.state.atlas))


def test_fleet_grow_resharding_keeps_live_sensors():
    """A 2-slot pool on a 4-entry mesh is replicated; grown to 4 it is
    sensor-sharded, and the live sensors finish as in the unsharded port
    fleet and the reference's."""
    mesh = cpu_mesh((4,))
    chunks = _chunks(_recordings(0.15))
    fleets = [FleetPipeline(TP.PipelineConfig(), n_sensors=2, device="cpu"),
              FleetPipeline(TP.PipelineConfig(), n_sensors=2, mesh=mesh),
              JP.FleetPipeline(JP.PipelineConfig(), n_sensors=2)]
    assert _carry_specs(fleets[1]) == {()}
    for fp in fleets:
        fp.feed(chunks[:2])
        fp.grow(4)
    assert _carry_specs(fleets[1]) == {SENSOR}
    for feed in (lambda fp: fp.feed([None, None, chunks[2], chunks[3]]), lambda fp: fp.flush()):
        a, b, j = (feed(fp) for fp in fleets)
        _stacked_equal(a, b)
        np.testing.assert_array_equal(np.asarray(b.clusters.count), np.asarray(j.clusters.count))
        _against_reference(b, j, range(4))


def test_fleet_slot_surgery_under_a_mesh_equals_unsharded():
    """reset_slots, export / import across pools of different meshes,
    flush_slots and shrink keep the placement and the bits: a stream
    hopped mid-way from a 2-entry-mesh pool into a 4-entry-mesh pool
    finishes as a dedicated stream."""
    recs = _recordings(0.2)
    a = FleetPipeline(CONST_CONFIG, n_sensors=2, mesh=cpu_mesh((2,)))
    b = FleetPipeline(CONST_CONFIG, n_sensors=8, mesh=cpu_mesh((4,)))
    rec = recs[1]
    cuts = np.linspace(0, len(rec), 7).astype(int)
    chunk = lambda i: (rec.x[cuts[i]:cuts[i + 1]], rec.y[cuts[i]:cuts[i + 1]],  # noqa: E731
                       rec.t[cuts[i]:cuts[i + 1]], rec.p[cuts[i]:cuts[i + 1]])
    parts = [a.feed([None, chunk(i)]).sensor(1) for i in range(3)]
    carry = a.export_slot(1)
    a.reset_slots([1])
    assert _carry_specs(a) == {SENSOR}
    np.testing.assert_array_equal(np.asarray(a.state.atlas)[1], 0)
    b.import_slot(5, carry)
    for i in range(3, 6):
        feed = [None] * 8
        feed[5] = chunk(i)
        parts.append(b.feed(feed).sensor(5))
    parts.append(b.flush_slots([5]).sensor(5))
    assert _carry_specs(b) == {SENSOR}
    want = _dedicated([chunk(i) for i in range(6)])
    assert compare_outputs(concat_outputs(parts), concat_outputs(want), "hopped stream") == []
    moved = b.export_slot(5)
    b.import_slot(1, moved)
    b.reset_slots([5])
    b.shrink(2, occupied=[1])  # 2 slots do not divide 4 entries: replicated
    assert _carry_specs(b) == {()}
    kept = b.export_slot(1)
    np.testing.assert_array_equal(kept.atlas, moved.atlas)
    for u, v in zip(kept.tracks, moved.tracks):
        np.testing.assert_array_equal(u, v)


# ---------------------------------------------------------------------------
# Carry migration across meshes, against the numpy oracle.
# ---------------------------------------------------------------------------


def _random_carry(rng, cap: int):
    return (
        rng.integers(-(10**6), 10**6, (cap, 5, 7)).astype(np.int32),
        {"pos": rng.normal(size=(cap, 3)).astype(np.float32),
         "age": rng.integers(0, 9, (cap, 4, 2)).astype(np.int32)},
    )


class _Pool:
    """One slot pool of the port: a placed carry, its numpy mirror, its
    mesh and its occupied slots (``tests/test_carry_migration.py``'s)."""

    def __init__(self, rng, cap: int, mesh):
        self.mesh = mesh
        self.mirror = _random_carry(rng, cap)
        self.carry = TS.shard_fleet_carry(TS._map(torch.from_numpy, self.mirror), mesh)
        self.occupied = set(range(cap))

    @property
    def cap(self) -> int:
        return self.carry[0].shape[0]

    def check(self, label: str) -> None:
        size = self.mesh.axis_sizes["sensor"]
        got, want = [], []
        TS._map(got.append, self.carry)
        TS._map(want.append, self.mirror)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.spec == (SENSOR if self.cap % size == 0 else ()), f"{label}[{i}] {g.spec}"
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=f"{label}[{i}]")

    def grow(self, new_cap: int) -> None:
        self.carry = TS.grow_fleet_carry(self.carry, new_cap, self.mesh)
        self.mirror = TS._map(lambda a: np.concatenate(
            [a, np.zeros((new_cap - a.shape[0],) + a.shape[1:], a.dtype)]), self.mirror)

    def shrink(self, new_cap: int) -> None:
        assert all(s < new_cap for s in self.occupied)
        self.carry = TS.shrink_fleet_carry(self.carry, new_cap, self.mesh)
        self.mirror = TS._map(lambda a: a[:new_cap].copy(), self.mirror)

    def permute(self, perm: np.ndarray) -> None:
        idx = torch.from_numpy(perm)
        self.carry = TS.shard_fleet_carry(TS._map(lambda a: TS.assemble(a)[idx], self.carry), self.mesh)
        self.mirror = TS._map(lambda a: a[perm].copy(), self.mirror)
        inv = {int(old): new for new, old in enumerate(perm)}
        self.occupied = {inv[s] for s in self.occupied}


def _set_row(carry, slot: int, rows: list):
    it = iter(rows)

    def put(a):
        out = TS.assemble(a).clone()
        out[slot] = next(it)
        return out

    return TS._map(put, carry)


def _migrate(src: _Pool, s_slot: int, dst: _Pool, d_slot: int) -> None:
    rows = []
    TS._map(lambda a: rows.append(a[s_slot].clone()), src.carry)
    dst.carry = TS.shard_fleet_carry(_set_row(dst.carry, d_slot, rows), dst.mesh)
    src.carry = TS.shard_fleet_carry(
        _set_row(src.carry, s_slot, [torch.zeros_like(r) for r in rows]), src.mesh)
    np_rows = [r.numpy() for r in rows]
    it = iter(np_rows)
    dst.mirror = TS._map(lambda a: _np_set(a, d_slot, next(it)), dst.mirror)
    src.mirror = TS._map(lambda a: _np_set(a, s_slot, np.zeros_like(a[s_slot])), src.mirror)
    src.occupied.discard(s_slot)
    dst.occupied.add(d_slot)


def _np_set(a: np.ndarray, slot: int, row: np.ndarray) -> np.ndarray:
    out = a.copy()
    out[slot] = row
    return out


def run_sequence(seed: int, mesh_a, mesh_b, steps: int = 12) -> int:
    """The reference's random grow -> migrate -> shrink -> permute
    sequence (``tests/test_carry_migration.py:run_sequence``, the same
    draws) over two port pools; every step oracle-checked. Returns the
    migrations made."""
    rng = np.random.default_rng(seed)
    pools = [_Pool(rng, 4, mesh_a), _Pool(rng, 4, mesh_b)]
    migrations = 0
    for step in range(steps):
        op = rng.choice(["grow", "shrink", "migrate", "permute"])
        p = pools[int(rng.integers(2))]
        if op == "grow" and p.cap < 16:
            p.grow(int(p.cap * 2))
        elif op == "shrink":
            top = max(p.occupied, default=-1)
            new_cap = max(top + 1, p.cap // 2, 1)
            if new_cap < p.cap:
                p.shrink(new_cap)
        elif op == "migrate":
            src, dst = (pools[0], pools[1]) if rng.integers(2) else (pools[1], pools[0])
            free = sorted(set(range(dst.cap)) - dst.occupied)
            if src.occupied and not free:
                dst.grow(int(dst.cap * 2))
                free = sorted(set(range(dst.cap)) - dst.occupied)
            if src.occupied and free:
                s_slot = int(rng.permutation(sorted(src.occupied))[0])
                d_slot = int(rng.permutation(free)[0])
                _migrate(src, s_slot, dst, d_slot)
                migrations += 1
        elif op == "permute":
            p.permute(rng.permutation(p.cap))
        for i, pool in enumerate(pools):
            pool.check(f"seed {seed} step {step} ({op}) pool {i}")
    return migrations


def test_grow_migrate_shrink_across_four_and_two_entry_meshes():
    import test_carry_migration as JCM
    from repro.launch.mesh import make_mesh as j_make_mesh

    mesh_a, mesh_b = cpu_mesh((4,)), cpu_mesh((2,))
    j_mesh = j_make_mesh((1,), ("sensor",))
    total = 0
    for seed in range(3):
        got = run_sequence(seed, mesh_a, mesh_b)
        assert got == JCM.run_sequence(seed, None, j_mesh, steps=12)  # the same sequence
        total += got
    assert total >= 2, total


# ---------------------------------------------------------------------------
# The constellation with multi-device shard groups.
# ---------------------------------------------------------------------------


def test_constellation_multidevice_shard_meshes():
    """4 devices, 2 shards: each shard gets a 2-entry sensor mesh; a
    session migrated across the meshes stays bit-identical to its
    dedicated stream, and within the bounds of the reference's
    constellation on the same schedule."""
    runs, fed = {}, {}
    for pkg in ("port", "reference"):
        if pkg == "port":
            cs = ConstellationService(
                CONST_CONFIG, n_shards=2, tiers=(2, 4), clock=_FakeClock(), sleep=lambda s: None,
                admission=_manual(),
                devices=[torch.device("cpu", i) for i in range(4)])
            assert [len(cs.shard(i).devices) for i in range(2)] == [2, 2]
            assert all(cs.shard(i).mesh is not None for i in range(2))
            assert cs.shard(0).devices != cs.shard(1).devices
            assert cs.shard(0).service._fleet.state.atlas.spec == SENSOR
        else:
            cs = _make("reference", tiers=(2, 4))
        gids = [cs.attach() for _ in range(2)]
        streams = {g: _Stream(400 + g) for g in gids}
        fed = {g: [] for g in gids}
        parts = {g: [] for g in gids}
        for rnd in range(4):
            for g in gids:
                chunk = streams[g].next(90)
                fed[g].append(chunk)
                for f in cs.feed(g, *chunk):
                    parts[f.gid].append(f.result)
            for f in cs.pump(force=True):
                parts[f.gid].append(f.result)
            if rnd == 1:
                cs.migrate(gids[0], 1 - cs.shard_of(gids[0]))
        for f in _drain_all(cs, gids):
            parts[f.gid].append(f.result)
        for g in gids:
            parts[g].append(cs.detach(g))
        assert cs.migrations == 1
        assert cs.exchange.stats["compression_ratio"] > 3.0
        runs[pkg] = parts
    for g in fed:
        assert compare_outputs(concat_outputs(runs["port"][g]), concat_outputs(_dedicated(fed[g])),
                               f"gid {g}") == []
        _assert_same(_surfaces(runs["port"][g]), _surfaces(runs["reference"][g]), exact=False,
                     what=f"gid {g}")


def _manual():
    from repro_torch.serve import AdmissionConfig

    return AdmissionConfig(**MANUAL)


# ---------------------------------------------------------------------------
# Checkpoints, LM batches, shard_map, hints.
# ---------------------------------------------------------------------------


def test_checkpoint_elastic_restore_resharded(tmp_path):
    """A checkpoint the reference wrote on one device restores onto a
    (4, 2) ("data", "model") mesh of 8 entries, each holding its block;
    saved from that placement, it restores onto a 2-entry mesh."""
    JCheckpointManager(tmp_path).save(2, {"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8)})
    mesh = cpu_mesh((4, 2), ("data", "model"))
    step, state = CheckpointManager(tmp_path).restore(
        {"w": torch.zeros(8, 8)}, shardings={"w": TS.named(mesh, ("data", "model"))})
    w = state["w"]
    assert step == 2 and w.spec == ("data", "model") and len(w.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(w).ravel(), np.arange(64))
    full = np.arange(64, dtype=np.float32).reshape(8, 8)
    for d in range(4):
        for m in range(2):
            np.testing.assert_array_equal(w.shard((d, m)).numpy(), full[2 * d:2 * d + 2, 4 * m:4 * m + 4])
    CheckpointManager(tmp_path).save(3, state)
    other = cpu_mesh((2,), ("data",))
    _, again = CheckpointManager(tmp_path).restore(
        {"w": torch.zeros(8, 8)}, shardings={"w": TS.named(other, ("data",))})
    assert again["w"].spec == ("data",)
    np.testing.assert_array_equal(again["w"].shard((1,)).numpy(), full[4:])
    _, j_state = JCheckpointManager(tmp_path).restore({"w": jnp.zeros((8, 8))})
    np.testing.assert_array_equal(np.asarray(j_state["w"]), full)


def test_sharded_batches_place_each_leaf_by_its_spec():
    mesh = cpu_mesh((4, 2), ("data", "model"))
    sharding = TS.named(mesh, ("data", None))
    got = list(TLM.sharded_batches(64, 8, 16, 3, sharding, seed=5))
    j_mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    want = list(JLM.sharded_batches(64, 8, 16, 3, jax.sharding.NamedSharding(
        j_mesh, jax.sharding.PartitionSpec("data", None)), seed=5))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].spec == ("data", None) and g[k].dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
            for d in range(4):
                rows = np.asarray(w[k])[2 * d:2 * d + 2]
                for m in range(2):  # replicated over "model"
                    np.testing.assert_array_equal(g[k].shard((d, m)).numpy(), rows)


def test_shard_map_node_array_equals_reference():
    """``examples/multi_node_array.py``'s per-node pipeline: grid clustering
    of each node's windows, one block a node entry, equal to the
    reference's grid clustering of the stacked array."""
    rng = np.random.default_rng(3)
    shape = (4, 6, 64)
    valid = rng.random(shape) < 0.7
    xs, ys = rng.integers(0, 640, shape), rng.integers(0, 480, shape)
    ts, ps = np.sort(rng.integers(0, 20_000, shape), axis=-1), rng.integers(0, 2, shape)
    leaves = [np.where(valid, a, 0).astype(np.int32) for a in (xs, ys, ts, ps)]
    batch = EventBatch(*(torch.from_numpy(a) for a in leaves), torch.from_numpy(valid))
    mesh = cpu_mesh((4,), ("node",))
    fn = shard_map(lambda b: grid_cluster(b, GridConfig()).count, mesh,
                   in_specs=(("node",),), out_specs=("node",))
    counts = fn(batch)
    assert counts.spec == ("node",) and counts.shard((2,)).shape == (1, 6, GridConfig().max_clusters)
    per_window = jax.vmap(jax.vmap(lambda eb: j_grid_cluster(eb, JGridConfig()).count))
    want = per_window(JEventBatch(*(jnp.asarray(a) for a in leaves), jnp.asarray(valid)))
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(want))
    with pytest.raises(ValueError, match="one mesh axis"):
        shard_map(lambda b: b, cpu_mesh((2, 2), ("a", "b")), in_specs=(("a",),), out_specs=("b",))(
            torch.zeros(4, 4))


def test_hints_are_the_identity_without_a_mesh_of_devices():
    x = torch.arange(32).reshape(4, 8)
    packed, valid, offsets = torch.zeros(4, 8, 2, 5), torch.zeros(8, 2, 5, dtype=torch.bool), torch.zeros(8, 3)
    assert TS.hint(x, "sensor") is x
    with use_mesh(Mesh((4,), SENSOR)):  # device-free: nothing to place on
        assert TS.hint_fleet((x,))[0] is x
    mesh = cpu_mesh((4,))
    with use_mesh(mesh):
        assert TS.hint(x, "sensor").spec == SENSOR
        assert TS.hint(x[:3], "sensor").spec == ()  # 3 does not divide by 4
        assert TS.hint(x, None, ("sensor", "model")).spec == (None, "sensor")  # no "model" axis
        w = TS.hint_wire(packed=packed, valid=valid, offsets=offsets, meta=torch.zeros(2, 8),
                         words=torch.zeros(5), spill=torch.zeros(2, 3))
        assert {k: v.spec for k, v in w.items()} == dict(
            packed=(None, "sensor"), valid=SENSOR, offsets=SENSOR, meta=(None, "sensor"), words=(), spill=())
        np.testing.assert_array_equal(np.asarray(w["packed"]), packed.numpy())
        assert w["words"].shard((3,)) is w["words"].shard((0,))  # one copy a device
    assert TS.hint(x, "sensor") is x
    assert TS.shard_fleet_carry((x,), None)[0] is x
    assert TS.shard_fleet_carry((x,), cpu_mesh((2,), ("data",)))[0] is x


def test_mesh_of_devices_refuses_what_it_cannot_place():
    with pytest.raises(ValueError, match="entries"):
        make_mesh((4,), SENSOR, devices=["cpu"] * 3)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh((1,), SENSOR)  # every CUDA device: none here
    with pytest.raises(ValueError, match="does not divide"):
        TS.place(torch.zeros(6), TS.named(cpu_mesh((4,)), SENSOR))
    with pytest.raises(TypeError, match="mesh of devices"):
        TS.named(Mesh((4,), SENSOR), SENSOR)


# ---------------------------------------------------------------------------
# The host view of a sparsely occupied pool.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [None, (4,)])
def test_sparse_pool_results_equal_reference(mesh_shape):
    """8 slots, 2 fed: the fed slots' results equal the reference's fleet
    (which gathers only their rows) and the idle slots' are empty, as
    the reference's. The port copies every row: on the card the gather
    took longer than the whole copy (tools/torch_host_view.py)."""
    recs = _recordings(0.2)
    kw = {"mesh": cpu_mesh(mesh_shape)} if mesh_shape else {"device": "cpu"}
    fp = FleetPipeline(TP.PipelineConfig(), n_sensors=8, **kw)
    ref = JP.FleetPipeline(JP.PipelineConfig(), n_sensors=8)
    feed = [None] * 8
    feed[2], feed[6] = _chunks(recs[:2])
    out, j_out = fp.feed(feed), ref.feed(feed)
    results, j_results = out.results(), j_out.results()
    assert j_out._hot_rows == {2: 0, 6: 1}
    assert out._host[0].count.shape[0] == 8
    for s in (0, 1, 3, 4, 5, 7):
        assert results[s].num_windows == j_results[s].num_windows == 0
        assert results[s].clusters.count.shape == tuple(np.asarray(j_results[s].clusters.count).shape)
    _against_reference(out, j_out, (2, 6))


def test_fleet_sweep_on_a_mesh_equals_unsharded():
    recs = [make_recording(seed=s, duration_s=0.3, n_rsos=1 + s % 2) for s in range(4)]
    plain = TP.collect_candidates_fleet(recs, device="cpu")
    sharded = TP.collect_candidates_fleet(recs, mesh=cpu_mesh((4,)))
    for a, b in zip(plain, sharded):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)
