"""ARACHNID-style multi-camera array on the PyTorch port (paper Sec. V-D/V-E).

The port's counterpart of ``examples/multi_node_array.py``. Each event
camera pairs with one processing node; the paper scales 1 -> 8 nodes with
linear throughput and invariant latency (Table V). Here the node axis is
a mesh axis of ``repro_torch.launch.mesh``: ``shard_map`` runs the same
per-node pipeline (grid clustering of every window, ``grid_cluster``)
once per node, on that node's mesh entry, and the per-node cluster
counts come back as one array laid out over the nodes. The run checks
them against one call over the whole stacked array.

On the card the mesh takes every visible GPU; with fewer GPUs than nodes
the nodes share them in turn (on one H100 every node runs on it, one
after another, so the throughput is that of one card). ``--device cpu``
gives each node a ``torch.device("cpu", i)`` entry.

  PYTHONPATH=src python examples/torch_multi_node_array.py --nodes 4
  PYTHONPATH=src python examples/torch_multi_node_array.py --nodes 4 --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.events import EventBatch, window_batches
from repro_torch.core.grid_clustering import GridConfig, grid_cluster
from repro_torch.data.synthetic import make_recording
from repro_torch.launch.mesh import make_mesh, shard_map

CAPACITY = 256


def node_devices(nodes: int, device: str) -> list[torch.device]:
    """One mesh entry a node: the visible GPUs in turn, or CPU entries."""
    if device == "cpu":
        return [torch.device("cpu", i) for i in range(nodes)]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False); pass --device cpu")
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(nodes)]


def stacked_windows(nodes: int, windows: int) -> EventBatch:
    """One synthetic recording a camera node, its first ``windows``
    fixed-stride windows stacked: each leaf ``(nodes, windows, CAPACITY)``
    on the host."""
    planes = np.zeros((5, nodes, windows, CAPACITY), np.int64)
    for n in range(nodes):
        rec = make_recording(seed=100 + n, duration_s=windows * 0.02, n_rsos=1 + n % 3)
        for w, (b, _) in enumerate(window_batches(rec.x, rec.y, rec.t, rec.p, capacity=CAPACITY,
                                                  device="cpu")):
            if w >= windows:
                break
            for i, leaf in enumerate(b):
                planes[i, n, w] = leaf.numpy()
    return EventBatch(*(torch.from_numpy(planes[i]).to(torch.int32) for i in range(4)),
                      torch.from_numpy(planes[4].astype(bool)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    grid = GridConfig()
    mesh = make_mesh((args.nodes,), ("node",), devices=node_devices(args.nodes, args.device))

    print(f"Simulating {args.nodes} camera nodes x {args.windows} windows...")
    stacked = stacked_windows(args.nodes, args.windows)

    def node_fn(batch: EventBatch) -> torch.Tensor:
        return grid_cluster(batch, grid).count  # (1, W, K): this node's windows

    per_node = shard_map(node_fn, mesh, in_specs=(("node",),), out_specs=("node",))
    per_node(stacked)  # warm-up
    sync = (lambda: torch.cuda.synchronize()) if args.device != "cpu" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    counts = per_node(stacked)
    sync()
    dt = time.perf_counter() - t0

    k = counts.numpy()
    whole = grid_cluster(EventBatch(*(a.to(counts.full().device) for a in stacked)), grid).count
    if not np.array_equal(k, whole.cpu().numpy()):
        raise SystemExit("per-node counts differ from one call over the stacked array")
    ev_total = int(stacked.valid.sum())
    print(f"nodes={args.nodes} windows={args.windows} events={ev_total:,} "
          f"devices={sorted({str(d) for d in mesh.devices.flat})}")
    print(f"aggregate throughput: {ev_total / dt / 1e6:.2f} MEv/s ({dt * 1e3:.1f} ms for the array)")
    per = [int((k[n] >= grid.min_events).sum()) for n in range(args.nodes)]
    print(f"clusters >= {grid.min_events} events per node: {per}; {sum(per)} across the array "
          f"(spec {counts.spec}), equal to one call over the stacked array")


if __name__ == "__main__":
    main()
