"""Serve detections on the PyTorch/CUDA port: dynamic sensor sessions over
the slot-pooled fleet on the GPU.

The port's counterpart of ``examples/serve_detections.py``, with the same
schedule. A ground station's sensors come and go while the service keeps
one slot-pooled fleet step hot: three stations attach up front (the pool
opens at the 4-slot tier); at round 25 two more join, and the fifth
attach promotes the pool to the 8-slot tier, live sessions unaffected; at
round 40 one of the originals leaves, its slot zeroed and recycled.
Chunks are micro-batched under the paper's dual-threshold admission
policy (20 ms / 250 events, Sec. III-A), so however many sessions are
live, each round costs one fleet step. Every session's outputs equal a
dedicated ``StreamingPipeline`` fed the same chunks.

The float datapath runs the kernel config (the ragged wire decoded by the
``event_unpack`` kernel, then the ``cluster_accum`` and ``patch_metrics``
kernels); ``--numerics fixed`` runs the fixed-point one (the
``window_pipeline`` kernel). On the CPU the kernels' plain versions run.

  PYTHONPATH=src python examples/torch_serve_detections.py            # on the GPU
  PYTHONPATH=src python examples/torch_serve_detections.py --device cpu
"""
import argparse
import dataclasses

from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.tracking import confirmed
from repro_torch.data.evas import iter_chunks
from repro_torch.data.synthetic import SCENARIO_FAMILIES, make_fleet_recordings
from repro_torch.serve import DetectionService

CHUNK_US = 20_000  # live cadence: one 20 ms chunk per sensor per round
FAMILIES = ("crossing", "geo_slow", "tumbling", "ballistic", "jitter")
ROUNDS, JOIN_AT, LEAVE_AT = 110, 25, 40


def _recording(idx: int, duration_s: float):
    fam = FAMILIES[idx % len(FAMILIES)]
    rec = make_fleet_recordings(1, scenario=SCENARIO_FAMILIES[fam], seed0=17 * idx,
                                duration_s=duration_s)[0]
    return dataclasses.replace(rec, name=f"station{idx}-{fam}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--duration", type=float, default=1.5, help="each station's recording, s")
    ap.add_argument("--numerics", choices=("float", "fixed"), default="float",
                    help="float32 datapath or the fixed-point one")
    args = ap.parse_args()

    if args.numerics == "fixed":
        config = PipelineConfig(numerics="fixed", metrics_impl="megakernel")
    else:
        config = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    svc = DetectionService(config, tiers=(4, 8, 16), device=args.device)
    print(f"DetectionService up on {svc.device}: tier capacity {svc.capacity} slots")

    feeds: dict[int, object] = {}  # sid -> chunk iterator (live cadence)
    names: dict[int, str] = {}

    def join(idx: int) -> int:
        rec = _recording(idx, args.duration)
        sid = svc.attach(rec.name)
        feeds[sid] = iter_chunks(rec, CHUNK_US)
        names[sid] = rec.name
        print(f"  + {rec.name} attached as session {sid} (slot {svc.session(sid).slot}, "
              f"pool {svc.capacity} slots, {len(rec):,} events)")
        return sid

    windows = dets = 0

    def count(served) -> None:
        nonlocal windows, dets
        for fd in served:
            windows += fd.result.num_windows
            dets += int(fd.result.clusters.valid.sum())

    first = [join(i) for i in range(3)]
    for rnd in range(ROUNDS):
        if rnd == JOIN_AT:  # two stations join -> tier promotion at the fifth
            join(3), join(4)
            print(f"    (pool promoted: capacity {svc.capacity}, promotions {svc.promotions})")
        if rnd == LEAVE_AT:  # one original leaves; its slot is recycled
            tail = svc.detach(first[0])
            windows += tail.num_windows
            st = svc.session(first[0]).stats
            print(f"  - session {first[0]} detached: {st.windows} windows, "
                  f"p50 service latency {st.latency_percentile(50):.1f} ms")
        for sid, chunks in list(feeds.items()):
            if svc.session(sid).state != "live":
                continue
            chunk = next(chunks, None)  # each session streams on its own clock
            if chunk is not None:
                count(svc.feed(sid, *chunk))  # admission may fire
        count(svc.pump(force=True))  # close the round deterministically

    print(f"\nProcessed {windows} windows, {dets} detections.")
    for sid in sorted(names):
        sess = svc.session(sid)
        n_conf = 0
        if sess.state == "live":
            final = svc.detach(sid)
            n_conf = int(confirmed(final.final_tracks, config.tracker).sum())
        st = sess.stats
        print(f"  {sess.name:<22} {st.events:>8,} events  {st.windows:>4} windows  "
              f"p99 latency {st.latency_percentile(99):6.1f} ms  "
              f"confirmed tracks at detach: {n_conf}")
    print(f"Promotions {svc.promotions}, step retries {svc.step_retries}, "
          f"degraded rounds {svc.degraded_rounds}; ingest wire "
          f"{svc.wire_stats.compression:.2f}x smaller than dense planes")


if __name__ == "__main__":
    main()
