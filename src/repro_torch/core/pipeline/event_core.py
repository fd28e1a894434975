"""The atlas event core: the float event route with its persistent,
window-tagged event surface.

The port of ``repro.core.pipeline.event_core`` (DESIGN.md Sec. 5), with
the step core's carry contract (see ``scan.py``):

    core(batch, state, atlas, tag0) -> (final, clusters, mets, states, atlas)

over ``(W, E)`` windows with an ``(H+1, max(width, E))`` atlas, or
``(S, W, E)`` windows with an ``(S, H+1, max(width, E))`` atlas; ``tag0``
is an int or an ``(S,)`` tensor on the device, the tag of each sensor's
first window. The reference replays its windows one by one through a
``lax.scan`` that writes each window's leader pixels into the atlas and
slices the count patches back out of it. This core computes the same
results without that sequential pass:

* Conditioning runs once per block of windows, then the event
  normalizer, once: its coincidence counts and leaders feed both the
  metrics and the atlas.
* Clusters and metrics are the straight event route's
  (:func:`~repro_torch.core.metrics.cluster_metrics_events`): the
  reference's atlas patches equal the event-built count patches bit for
  bit (its ``tests/test_event_metrics.py``).
* The atlas after the call holds, at each pixel, the encoding
  ``((tag0 + w + 1) << shift) | (c & mask)`` of the latest window ``w``
  whose leader lies there; other pixels keep their value. Every value
  already in the atlas carries a smaller tag than any window of the call
  (the drivers zero the atlas at tag rollover, padding windows have no
  leaders, and a sensor's next tag is ``tag0 + n``), so the update is one
  ``scatter_reduce_(..., "amax")`` per block of the leaders' encodings into
  a copy of the flattened atlas. Non-leaders write a 0 into the dump row
  (row ``H``) at their event index, as in the reference, so the dump row
  and the columns past the sensor's width stay zero.

``config.scan_chunk`` is accepted and changes nothing. Nothing here waits
on the device: no host copy, no boolean indexing.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.core import metrics as M
from repro_torch.core.events import EventBatch
from repro_torch.core.pipeline.config import (
    PipelineConfig,
    _histogram_fn,
    atlas_shape,
    check_supported,
)
from repro_torch.core.pipeline.window_core import (
    _cluster,
    _condition,
    _flat_blocks,
    _gather_and_track,
)
from repro_torch.core.tracking import TrackState


def _write_atlas(atlas_flat, batch, c, leader, window_ix, n_per_sensor: int, tag0,
                 shift: int, plane: int, row: int, height: int) -> None:
    """Scatter one block's leader encodings into the flattened atlas copy.
    ``window_ix`` holds the flattened window indices of the block's rows;
    window ``i`` belongs to sensor ``i // n_per_sensor`` at local window
    ``i % n_per_sensor``. Each non-leader adds a 0 to its sensor's dump
    row at its event index: no change, as every atlas value is >= 0, and
    no two events of a window share an address."""
    s = torch.div(window_ix, n_per_sensor, rounding_mode="floor")
    local = (window_ix - s * n_per_sensor).to(torch.int32)
    if torch.is_tensor(tag0):
        tags = tag0.to(device=local.device, dtype=torch.int32).reshape(-1)[s] + local
    else:
        tags = local + int(tag0)
    mask = (1 << shift) - 1
    enc = ((tags + 1) << shift)[:, None] | (c & mask)
    base = (s * plane)[:, None]
    pix = base + batch.y.to(torch.int64) * row + batch.x
    dump = base + height * row + torch.arange(batch.x.shape[-1], device=base.device)
    atlas_flat.scatter_reduce_(
        0, torch.where(leader, pix, dump).reshape(-1),
        torch.where(leader, enc, 0).reshape(-1), "amax", include_self=True,
    )


def make_event_core(config: PipelineConfig, with_tracking: bool = True):
    """The atlas event core for a float ``metrics_impl="event"`` config;
    see the module docstring for its contract."""
    check_supported(config)
    hist_fn = _histogram_fn(config)
    width, height = config.grid.width, config.grid.height

    def core(batch: EventBatch, state: TrackState, atlas: torch.Tensor, tag0=0):
        lead, cap = batch.x.shape[:-1], batch.x.shape[-1]
        want = (*lead[:-1], *atlas_shape(config, cap))
        if tuple(atlas.shape) != want:
            raise ValueError(f"atlas shape {tuple(atlas.shape)}, expected {want} for "
                             f"windows {tuple(batch.x.shape)}")
        shift = max(cap.bit_length(), 1)  # pixel counts fit in `shift` bits
        plane, row = atlas.shape[-2] * atlas.shape[-1], atlas.shape[-1]
        n_per_sensor = max(lead[-1], 1)
        atlas = atlas.clone(memory_format=torch.contiguous_format)  # never the caller's
        atlas_flat = atlas.view(-1)
        parts = []
        for lo, block in _flat_blocks(batch):
            with record_function("conditioning"):
                block = _condition(config, block)
            with record_function("clustering"):
                clusters = _cluster(config, hist_fn, block)
            with record_function("metrics"):
                c, leader, w, norm = M.event_normalizer(block, width, height)
                mets = M._event_metrics(block, clusters, c, leader, w, norm, width, height)
            with record_function("atlas"):
                ix = torch.arange(lo, lo + block.x.shape[0], device=block.x.device)
                _write_atlas(atlas_flat, block, c, leader, ix, n_per_sensor, tag0,
                             shift, plane, row, height)
            parts.append((clusters, mets))
        return (*_gather_and_track(config, with_tracking, lead, parts, state), atlas)

    return core
