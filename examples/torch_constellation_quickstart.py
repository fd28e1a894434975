"""Constellation quickstart on the PyTorch/CUDA port: sensor sessions
sharded over service shards on one GPU.

The port's counterpart of ``examples/constellation_quickstart.py``, on
the same surveillance-network scenario: six ground stations stream into
a 2-shard :class:`~repro_torch.serve.ConstellationService`. With one
card both shards share it, as the reference's shards share its one
device. The planner places each new station on the least-loaded shard;
every round each up shard dispatches its own pipelined fleet step
(rounds interleave on the card's stream) and publishes an int8 +
error-feedback compressed summary plane to its peers through the
cross-shard exchange. Mid-run one station is migrated by hand — its slot
carry is the entire stream state, so the stream resumes bit-identically
on the new shard — and a simulated whole-shard outage is rescued: the
stalled shard's sessions re-migrate to the survivor, no stream lost, and
the shard is revived once "repaired". The shards run the float kernel
routes (``event_unpack``, ``cluster_accum``, ``patch_metrics``), or with
``--numerics fixed`` the fixed-point megakernel.

  PYTHONPATH=src python examples/torch_constellation_quickstart.py            # on the GPU
  PYTHONPATH=src python examples/torch_constellation_quickstart.py --device cpu
"""
import argparse
import dataclasses

from repro_torch.core.pipeline import PipelineConfig
from repro_torch.data.evas import iter_chunks
from repro_torch.data.synthetic import SCENARIO_FAMILIES, make_fleet_recordings
from repro_torch.serve import ConstellationService, FaultConfig
from repro_torch.serve.chaos import _FlakyFleet

CHUNK_US = 20_000  # live cadence: one 20 ms chunk per sensor per round
FAMILIES = ("crossing", "geo_slow", "tumbling", "ballistic", "jitter")


def _recording(idx: int):
    fam = FAMILIES[idx % len(FAMILIES)]
    rec = make_fleet_recordings(
        1, scenario=SCENARIO_FAMILIES[fam], seed0=31 * idx, duration_s=1.0
    )[0]
    return dataclasses.replace(rec, name=f"station{idx}-{fam}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--numerics", choices=("float", "fixed"), default="float",
                    help="float32 datapath or the fixed-point one")
    args = ap.parse_args()

    if args.numerics == "fixed":
        config = PipelineConfig(numerics="fixed", metrics_impl="megakernel")
    else:  # paper defaults: 16 px cells, 20 ms / 250 events, kernel routes
        config = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    cs = ConstellationService(
        config,
        n_shards=2,
        tiers=(4, 8),
        faults=FaultConfig(degrade_on_step_failure=True, max_step_retries=0),
        rescue_after_degraded_rounds=2,
        devices=[args.device],
    )
    print(
        f"constellation up: {cs.n_shards} shards on {cs.shard(0).service.device}, "
        f"{cs.capacity} slots total, exchange={cs.exchange.mode}"
    )

    feeds, windows = {}, 0
    for i in range(6):
        rec = _recording(i)
        gid = cs.attach(rec.name)
        feeds[gid] = iter_chunks(rec, CHUNK_US)
        print(f"  + {rec.name} -> gid {gid} on shard {cs.shard_of(gid)}")
    print(f"placement: loads {cs.loads}")

    def round_(rnd: int) -> int:
        served = []
        for gid, it in list(feeds.items()):
            chunk = next(it, None)
            if chunk is None:
                continue
            served += cs.feed(gid, *chunk)
        served += cs.pump(force=True)
        return sum(f.num_windows for f in served)

    for rnd in range(10):
        windows += round_(rnd)

    mover = next(iter(feeds))
    cs.migrate(mover, 1 - cs.shard_of(mover))
    print(
        f"migrated gid {mover} to shard {cs.shard_of(mover)} "
        f"(stream state = slot carry; resumes bit-identically)"
    )

    # Simulate a whole-shard outage: every fleet dispatch on shard 0
    # fails until "repaired". Two degraded rounds trip the rescue.
    stalled = _FlakyFleet(cs.shard(0).service._fleet)
    stalled.fail_next = 10**9
    cs.shard(0).service._fleet = stalled
    for rnd in range(4):
        windows += round_(rnd)
    print(
        f"shard 0 stalled -> rescued: down={cs.down_shards}, "
        f"loads {cs.loads}, sessions lost: {6 - cs.n_sessions}"
    )
    stalled.fail_next = 0
    cs.revive_shard(0)
    print(f"shard 0 repaired and revived: down={cs.down_shards}")

    for rnd in range(6):
        windows += round_(rnd)
    for gid in list(feeds):
        cs.detach(gid)

    st = cs.stats()
    ex = st["exchange"]
    print(
        f"done: {windows} windows, {st['migrations']} migrations "
        f"({st['rescues']} rescue), exchange {ex['rounds']} rounds at "
        f"{ex['compression_ratio']:.2f}x compression "
        f"({ex['wire_bytes']:,} vs {ex['exact_bytes']:,} bytes)"
    )


if __name__ == "__main__":
    main()
