"""Batched-serving launcher using the paper's dual-threshold batcher.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --requests 24 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.launch.train import reduced_config
from repro_torch.models.transformer import init_params
from repro_torch.serve.lm import EngineConfig, Request, ServingEngine


def serve_demo(
    arch: str = "llama3.2-1b",
    n_requests: int = 24,
    prompt_len: int = 16,
    max_new: int = 8,
    max_batch: int = 8,
    max_delay_s: float = 0.02,
    seed: int = 0,
    device="cuda",
) -> dict:
    """The reference's demo on ``device``: the ``tiny`` preset, random
    weights from ``seed``, ``n_requests`` prompts of ``prompt_len`` random
    tokens served ``max_new`` tokens each."""
    dev = resolve_device(device)
    cfg = reduced_config(arch, "tiny")
    model = init_params(seed, cfg, device=dev)
    engine = ServingEngine(
        model,
        EngineConfig(max_delay_s=max_delay_s, max_batch=max_batch,
                     max_seq=prompt_len + max_new + 1),
        device=dev,
    )
    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    for i in range(n_requests):
        engine.submit(Request(
            rid=i,
            tokens=list(rng.integers(0, cfg.vocab, prompt_len)),
            max_new_tokens=max_new,
        ))
    done = engine.run_until_drained()
    wall = time.monotonic() - t0
    tokens_out = sum(len(r.output) for r in done)
    return {
        "requests": len(done),
        "tokens_generated": tokens_out,
        "wall_s": round(wall, 3),
        "tokens_per_s": round(tokens_out / wall, 1),
        "mean_batch_latency_s": round(
            float(np.mean([r.batch_latency_s for r in done])), 4
        ),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    stats = serve_demo(
        args.arch, args.requests, max_batch=args.max_batch,
        max_delay_s=args.max_delay_ms / 1e3, device=args.device,
    )
    for k, v in stats.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
