"""Batched LM serving engine: a thin client of the shared admission batcher.

The port of ``repro.serve.lm``. The dual-threshold policy lives in
:mod:`repro_torch.serve.batcher`; this module keeps only what is
LM-specific: request bookkeeping, padded prefill and the shared-position
decode loop. The engine runs static batches with the reference's
semantics: queued prompts are left-padded with token 0 to a common length
(nothing masks the pad), prefilled together, then decoded together with
one position counter shared by every row (``max_len + step``), greedy
``argmax`` (the first maximal index) and per-request stop bookkeeping, so
a batch that runs to ``max_new`` makes ``max_new - 1`` decode calls. The
tokens come back to the host once a step, with one ``.tolist()``.

The engine serves a copy of the model's weights cast once to the config's
dtype on its device (:func:`repro_torch.models.transformer.cast_weights`);
the reference casts its float32 masters at every use, which gives the
same bits.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import Transformer, cast_weights, decode_step, prefill
from repro_torch.serve.batcher import AdmissionConfig, DualThresholdAdmitter


@dataclasses.dataclass
class Request:
    rid: int
    tokens: list[int]
    max_new_tokens: int = 16
    arrival_s: float = 0.0
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    batch_latency_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_delay_s: float = 0.020  # paper: 20 ms window
    max_batch: int = 8  # paper: 250 events; scaled to LM requests
    max_seq: int = 256
    eos_token: int = -1  # disabled by default


class DualThresholdBatcher:
    """LM-request admission: the generic admitter at unit weight.

    ``submit`` stamps ``Request.arrival_s`` and ``queue`` exposes the
    pending requests, as in the reference.
    """

    def __init__(self, cfg: EngineConfig, clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self._admit: DualThresholdAdmitter[Request] = DualThresholdAdmitter(
            AdmissionConfig(max_delay_s=cfg.max_delay_s, max_items=cfg.max_batch),
            clock,
        )

    @property
    def queue(self) -> list[Request]:
        return self._admit.items

    def submit(self, req: Request) -> None:
        req.arrival_s = self.clock()
        self._admit.submit(req)

    def ready(self) -> bool:
        return self._admit.ready()

    def pop_batch(self) -> list[Request]:
        return self._admit.pop()


class ServingEngine:
    """Serves ``model`` on ``device`` (the card unless ``device="cpu"``).

    The reference's ``ServingEngine(params, cfg, engine_cfg, clock)``; the
    model carries its config, so there is no ``cfg`` argument. The engine
    keeps a copy of the weights cast to the config's dtype on ``device``
    (2.47 GB in bf16 for ``llama3.2-1b``, beside the caller's float32
    masters, which the caller may drop)."""

    def __init__(
        self,
        model: Transformer,
        engine_cfg: EngineConfig = EngineConfig(),
        clock: Callable[[], float] = time.monotonic,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.model = cast_weights(model, device=self.device)
        self.ecfg = engine_cfg
        self.clock = clock
        self.batcher = DualThresholdBatcher(engine_cfg, clock)
        self._prefill = partial(prefill, self.model, cache_len=engine_cfg.max_seq)
        self._decode = partial(decode_step, self.model)

    def submit(self, req: Request) -> None:
        self.batcher.submit(req)

    def step(self) -> list[Request]:
        """Serve one ready batch (or nothing). Returns completed requests."""
        if not self.batcher.ready():
            return []
        batch = self.batcher.pop_batch()
        t0 = self.clock()
        b = len(batch)
        lens = [len(r.tokens) for r in batch]
        max_len = max(lens)
        toks = np.zeros((b, max_len), np.int32)
        for i, r in enumerate(batch):
            toks[i, max_len - lens[i]:] = r.tokens  # left-pad to align ends
        logits, cache = self._prefill({"tokens": torch.from_numpy(toks)})
        max_new = max(r.max_new_tokens for r in batch)
        cur = torch.argmax(logits, -1)
        done = np.zeros(b, bool)
        for step in range(max_new):
            host = cur.tolist()  # the step's one host synchronization
            for i, r in enumerate(batch):
                if not done[i] and step < r.max_new_tokens:
                    tok = host[i]
                    r.output.append(tok)
                    if tok == self.ecfg.eos_token:
                        done[i] = True
                if len(r.output) >= r.max_new_tokens:
                    done[i] = True
            if done.all():
                break
            logits, cache = self._decode({"tokens": cur[:, None]}, cache, max_len + step)
            cur = torch.argmax(logits, -1)
        dt = self.clock() - t0
        for r in batch:
            r.batch_latency_s = dt
        return batch

    def run_until_drained(self, budget_s: float = 60.0) -> list[Request]:
        out: list[Request] = []
        t0 = self.clock()
        while self.batcher.queue and (self.clock() - t0) < budget_s:
            out.extend(self.step())
            if not self.batcher.ready() and self.batcher.queue:
                # force the time threshold for the tail batch
                time.sleep(min(self.ecfg.max_delay_s, 0.02))
        return out
