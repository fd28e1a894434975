"""Checkpoints with async save and restore onto a device: the port of
``repro.train.checkpoint``, in the same on-disk layout.

* **Layout** — ``<dir>/step_XXXXXXXX/arrays.npz`` holds every leaf of the
  state tree (nested dicts, lists and tuples of tensors or numpy arrays)
  as a full numpy array, keyed by its path: dict keys and list indices
  joined by ``/``; ``meta.json`` holds the caller's metadata and the
  step. A state in the reference's tree layout (``{"params":
  params_to_numpy(model), "opt": opt_state_to_numpy(...)}``) written by
  either package restores in the other.
* **Atomicity** — writes go to ``<dir>.tmp`` then ``os.replace`` onto the
  final name; a crash mid-save never corrupts the latest checkpoint.
* **Async** — ``save_async`` copies every leaf to host memory before it
  returns (the port's optimizer updates tensors in place, so a reference
  would not be a snapshot; ``.cpu()`` of a CPU tensor is no copy), then
  writes on a worker thread.
* **Retention** — ``keep_n`` newest checkpoints survive garbage collection.

``restore(template, step, device)`` rebuilds the template's tree with the
template's dtypes, on ``device`` (every leaf a tensor there) or, without
one, each tensor leaf on its template's device. ``shardings=`` (a tree of
:func:`~repro_torch.distributed.sharding.named` placements, like the
state's) then lays each leaf out by its mesh spec, whatever mesh the state
was saved from: the reference's elastic re-shard path. A state of
``Placed`` leaves saves as its global arrays.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import NamedSharding, Placed, place


def _leaf_array(leaf, copy: bool) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy).numpy()
    return np.array(leaf, copy=copy) if copy else np.asarray(leaf)


def _items(node):
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    return [(str(i), v) for i, v in enumerate(node)]


def _flatten(tree: Any, copy: bool = False, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, (dict, list, tuple)):
        flat: dict[str, np.ndarray] = {}
        for k, v in _items(tree):
            flat.update(_flatten(v, copy, f"{prefix}{k}/"))
        return flat
    if tree is None:
        return {}
    return {prefix[:-1]: _leaf_array(tree, copy)}


def _unflatten_into(template: Any, flat: dict[str, np.ndarray], device, prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, device, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, device, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    if template is None:
        return None
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    shape = tuple(template.shape) if hasattr(template, "shape") else np.shape(template)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {key!r}: ckpt {arr.shape} vs model {shape}")
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            device=template.device if device is None else device, dtype=template.dtype)
    if isinstance(template, Placed):
        out = torch.from_numpy(np.array(arr)).to(template.dtype)
        return place(out, template.sharding) if device is None else out.to(device)
    out = arr.astype(np.asarray(template).dtype)
    return out if device is None else torch.from_numpy(out).to(device)


def _place_tree(state: Any, shardings: Any) -> Any:
    """Every leaf of ``state`` placed by the matching leaf of ``shardings``."""
    if isinstance(shardings, NamedSharding):
        return place(state, shardings)
    if shardings is None:
        return state
    if isinstance(state, dict):
        return {k: _place_tree(v, shardings[k]) for k, v in state.items()}
    return type(state)(_place_tree(v, s) for v, s in zip(state, shardings))


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_n: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    def _write(self, step: int, flat: dict[str, np.ndarray], meta: dict) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "meta.json").write_text(json.dumps(dict(meta, step=step)))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def save(self, step: int, state: Any, meta: dict | None = None) -> None:
        """Blocking save (atomic)."""
        self.wait()
        self._write(step, _flatten(state), meta or {})

    def save_async(self, step: int, state: Any, meta: dict | None = None) -> None:
        """Copy every leaf to host memory, then write on a background thread."""
        self.wait()
        flat = _flatten(state, copy=True)  # host snapshot
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, meta or {}), daemon=True
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> int | None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp")
        )
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None, device=None,
                shardings: Any = None) -> tuple[int, Any]:
        """Restore into ``template``'s structure and dtypes; see the module
        docstring for where the leaves go. ``shardings`` is a tree of the
        state's structure whose ``NamedSharding`` leaves place theirs
        (``None`` leaves, or a missing tree, leave them as restored)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        with np.load(path / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        state = _unflatten_into(template, flat, None if device is None else resolve_device(device))
        if shardings is not None:
            state = _place_tree(state, shardings)
        return step, state

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp")
        )
        for s in steps[: -self.keep_n]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
