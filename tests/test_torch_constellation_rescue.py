"""Whole-shard rescue in the port's constellation
(``repro_torch.serve.constellation``) on the CPU, against the JAX
package's: the rescue cases of ``tests/test_constellation.py``, each run
through both packages on the same schedule, with the comparisons and
bounds of ``tests/test_torch_constellation.py`` (whose helpers this file
uses).
"""
import pytest
import torch

from repro.serve import chaos as JC
from repro_torch.serve import FaultConfig
from repro_torch.serve.chaos import _FlakyFleet, _Stream
from test_torch_constellation import PACKAGES, _assert_sessions, _drain_all, _make

torch.set_num_threads(1)


def _rescue_run(pkg: str):
    cs = _make(pkg, faults=FaultConfig(degrade_on_step_failure=True, max_step_retries=0),
               rescue_after_degraded_rounds=2)
    flaky = _FlakyFleet if pkg == "port" else JC._FlakyFleet
    gids = [cs.attach() for _ in range(4)]
    streams = {g: _Stream(200 + g) for g in gids}
    fed = {g: [] for g in gids}
    parts = {g: [] for g in gids}

    def feed_round():
        for g in gids:
            chunk = streams[g].next(90)
            fed[g].append(chunk)
            for f in cs.feed(g, *chunk):
                parts[f.gid].append(f.result)
        for f in cs.pump(force=True):
            parts[f.gid].append(f.result)

    feed_round()  # healthy warm-up round
    stalled = flaky(cs.shard(0).service._fleet)
    stalled.fail_next = 10**9
    cs.shard(0).service._fleet = stalled
    victims = [g for g in gids if cs.shard_of(g) == 0]
    for _ in range(3):
        feed_round()
    assert cs.rescues == 1 and cs.down_shards == [0]
    assert cs.loads == [0, 4]
    assert all(cs.shard_of(g) == 1 for g in victims)
    assert cs.n_sessions == 4  # moved, not lost
    for _ in range(2):
        feed_round()
    for f in _drain_all(cs, gids):
        parts[f.gid].append(f.result)
    for g in gids:
        parts[g].append(cs.detach(g))
    stalled.fail_next = 0
    cs.revive_shard(0)  # re-admitted for new placements
    assert cs.shard_of(cs.attach()) == 0
    return cs, parts, fed


def test_shard_stall_rescue_bit_identity():
    """A whole-shard stall (every fleet dispatch failing) triggers the
    rescue after two degraded rounds; its sessions re-migrate and keep
    streaming bit-identically, in both packages alike."""
    runs = {pkg: _rescue_run(pkg) for pkg in PACKAGES}
    (t, t_parts, fed), (j, j_parts, _) = runs["port"], runs["reference"]
    _assert_sessions({"port": t_parts, "reference": j_parts}, fed)
    assert t.stats()["shards"][0]["degraded_rounds"] == j.stats()["shards"][0]["degraded_rounds"] == 2
    assert (t.migrations, t.rescues) == (j.migrations, j.rescues) == (2, 1)
    assert [(e.kind, e.sid, e.time_s) for e in t.shard(0).service.errors] == \
        [(e.kind, e.sid, e.time_s) for e in j.shard(0).service.errors]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_rescue_refuses_when_no_survivor(pkg):
    cs = _make(pkg)
    assert cs.rescue_shard(1) == 0  # nothing to move; shard 1 downed
    with pytest.raises(RuntimeError, match="no other shard is up"):
        cs.rescue_shard(0)  # would strand any stream with nowhere to go
    cs.shard(0).down = True
    with pytest.raises(RuntimeError, match="every shard is down"):
        cs.attach()
    cs.revive_shard(0)
    assert cs.shard_of(cs.attach()) == 0
