#!/usr/bin/env python3
"""Teacher forcing of ``chip_smoke.py`` phase 10's served batch: the
measurement behind each family's bound (``LM10_TEACHER_ATOL``) and the
control that bound must stay under.

    PYTHONPATH=src python tools/torch_lm_teacher_bound.py --device cpu \
        [--arch recurrentgemma-9b ...]

For each family and seed (``SEEDS``): phase 10's config (full width, the served
depth), random weights from ``torch.Generator`` seed ``s`` on the device,
the engine's bf16 copy, 8 requests of 16-64 prompt tokens from
``default_rng(s)`` and 16 new tokens in one batch, a MoE family without
drops (``chip_smoke.no_drop``), as phase 10b holds it; then
``forward_train`` over the prompts and answers against the logits that
served them. At the first seed also the control: the batch served with a
cache that decode never writes (``served_logits(stale_cache=True)``). One
JSON line a family and seed. The device is the card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)

SEEDS = (0, 1, 2)


def measure(arch: str, dev, seed: int, control: bool) -> dict:
    import torch

    from repro_torch.models import Transformer
    from repro_torch.serve.lm import EngineConfig, ServingEngine

    cfg = C.family_config(arch)
    t0 = time.perf_counter()
    masters = Transformer(cfg, seed, device=dev)
    engine = ServingEngine(masters, EngineConfig(**C.LM_ENGINE), device=dev)
    del masters
    engine.model.cfg = C.no_drop(cfg)
    out = dict(arch=arch, seed=seed, device=str(dev), n_layers=cfg.n_layers, params=cfg.param_count(),
               init_s=time.perf_counter() - t0, torch=torch.__version__, threads=torch.get_num_threads())
    prompts = C.lm_requests(cfg.vocab, C.LM10_REQUESTS, seed)
    for name in ("sound", "control") if control else ("sound",):
        t0 = time.perf_counter()
        done, logits = C.served_logits(engine, prompts, stale_cache=name == "control")
        r = C.teacher_forcing(engine, done, logits, 0.0)
        out[name] = dict(max_abs_err=r["max_abs_err"], seconds=time.perf_counter() - t0)
        if name == "sound":
            again = C.teacher_forcing(engine, done, logits, r["max_abs_err"])
            out[name].update(tokens_equal_past_twice_it=again["agree"], clear=again["clear"],
                             positions=again["positions"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", nargs="*", default=list(C.LM10_FAMILIES))
    args = ap.parse_args()
    from repro_torch import resolve_device

    dev = resolve_device(args.device)
    for arch in args.arch:
        for i, seed in enumerate(SEEDS):
            print(json.dumps(measure(arch, dev, seed, control=i == 0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
