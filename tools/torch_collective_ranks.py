"""Every case of the port's int8 collectives in one 4-rank ``gloo`` group
on the CPU, one process a rank, each rank's results saved to
``OUT_DIR/rank<r>.npz`` (``tests/test_torch_collectives.py`` holds them
against the reference; ``tools/torch_lm_phase.py 13`` runs it on the
card machine's CPU).

    PYTHONPATH=src python tools/torch_collective_ranks.py OUT_DIR

The group meets through a ``file://`` store in ``OUT_DIR`` (no port is
bound). Inputs are made here from the seeds of the reference's tests
(``tests/test_compression.py``), so the parent can run the reference on
the same arrays.
"""
import ast
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N = 4
RING_SIZES = (64, 63, 1)


def shards(seed: int, shape) -> np.ndarray:
    """Every rank's input, stacked (the reference tests' ``_shards``)."""
    return np.random.default_rng(seed).normal(size=(N,) + shape).astype(np.float32)


def identity_input() -> np.ndarray:
    return np.random.default_rng(8).normal(size=10).astype(np.float32)


def _hops(counter) -> np.ndarray:
    """(operand shape's elements, calls, collective bytes) of every
    all-to-all the counter saw."""
    return np.array([
        [ast.literal_eval(shapes)[0][0], rec.calls, rec.coll_bytes]
        for (name, shapes), rec in counter.records.items()
        if name == "_c10d_functional.all_to_all_single"
    ], dtype=np.float64).reshape(-1, 3)


def _kinds(counter) -> np.ndarray:
    """Calls of each collective kind: all-reduce, all-to-all."""
    calls = {"all-reduce": 0.0, "all-to-all": 0.0}
    for rec in counter.records.values():
        if rec.coll_kind in calls:
            calls[rec.coll_kind] += rec.calls
    return np.array([calls["all-reduce"], calls["all-to-all"]])


def run_rank(rank: int, out_dir: str, init: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=N)
    from repro_torch.distributed import compression as C
    from repro_torch.launch.op_analysis import OpCounter

    pg = dist.group.WORLD
    singles = [dist.new_group([r]) for r in range(N)]  # every rank makes every group
    res = {}

    x = torch.from_numpy(shards(4, (128,))[rank])
    q, max_scale = C._aligned_int8(x, pg)
    res["psum_q"], res["psum_scale"] = q.numpy(), max_scale.numpy()
    with OpCounter() as counter:
        res["psum"] = C.compressed_psum_int8(x, pg).numpy()
    res["psum_kinds"] = _kinds(counter)

    tree = {"w": torch.from_numpy(shards(5, (16, 3))[rank]),
            "b": torch.from_numpy(shards(6, (3,))[rank])}
    out = C.dp_grad_sync_int8(tree, pg)
    res["dp_w"], res["dp_b"] = out["w"].numpy(), out["b"].numpy()

    for n in RING_SIZES:
        xr = torch.from_numpy(shards(7, (n,))[rank])
        with OpCounter() as counter:
            res[f"ring{n}"] = C.ring_allreduce_int8(xr, pg, N).numpy()
        res[f"ring{n}_hops"] = _hops(counter)
    res["ring2d"] = C.ring_allreduce_int8(torch.from_numpy(shards(9, (5, 7))[rank]), pg).numpy()

    one = torch.from_numpy(identity_input())
    res["ring_one"] = C.ring_allreduce_int8(one, singles[rank], 1).numpy()
    res["ring_one_is_x"] = np.array(C.ring_allreduce_int8(one, singles[rank]) is one)
    try:
        C.compressed_psum_int8(torch.zeros(3, device="meta"), pg)
        res["refused"] = np.array(False)
    except ValueError:
        res["refused"] = np.array(True)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def check(out_dir) -> dict:
    """What can be held without the reference: every rank's output equal
    to every other's, each within the reference tests' tolerances of the
    float32 mean, each ring hop one chunk of int16, the group of one the
    identity, the other device refused. Raises on a failure; returns the
    largest error against the mean of each case."""
    ranks = [dict(np.load(pathlib.Path(out_dir) / f"rank{r}.npz")) for r in range(N)]
    cases = {"psum": (shards(4, (128,)), 1.0), "dp_w": (shards(5, (16, 3)), 1.0),
             "dp_b": (shards(6, (3,)), 1.0), "ring2d": (shards(9, (5, 7)), 1.5)}
    cases.update({f"ring{n}": (shards(7, (n,)), 1.5) for n in RING_SIZES})
    errs = {}
    for key, (x, slack) in cases.items():
        for r in range(1, N):
            if not np.array_equal(ranks[r][key], ranks[0][key]):
                raise AssertionError(f"{key}: rank {r} differs from rank 0")
        err = float(np.abs(ranks[0][key] - x.mean(axis=0)).max())
        tol = (np.abs(x).max(axis=tuple(range(1, x.ndim))).max() if key == "psum"
               else np.abs(x).max()) / 127.0 * slack + 1e-6
        if err > tol:
            raise AssertionError(f"{key}: {err} from the float32 mean, past {tol}")
        errs[key] = err
    for n in RING_SIZES:
        chunk = -(-n // N)
        for r in range(N):
            hops = ranks[r][f"ring{n}_hops"]
            if hops.tolist() != [[2 * chunk, 2 * (N - 1), 2 * (N - 1) * 2 * chunk]]:
                raise AssertionError(f"ring{n} rank {r}: hops {hops.tolist()}")
    for r in range(N):
        if not (np.array_equal(ranks[r]["ring_one"], identity_input()) and ranks[r]["ring_one_is_x"]
                and ranks[r]["refused"]):
            raise AssertionError(f"rank {r}: the group of one or the refusal")
    return errs


def main(out_dir: str) -> None:
    out = pathlib.Path(out_dir).resolve()
    out.mkdir(parents=True, exist_ok=True)
    (out / "store").unlink(missing_ok=True)  # a store left by an earlier run would not rendezvous
    init = "file://" + str(out / "store")
    mp.spawn(run_rank, args=(out_dir, init), nprocs=N, join=True)


if __name__ == "__main__":
    main(sys.argv[1])
