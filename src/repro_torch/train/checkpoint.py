"""Checkpointing for fault tolerance, in the reference's on-disk layout.

* **Atomic**: state is written to ``<dir>/tmp-<step>`` and ``os.replace``d
  into ``<dir>/step-<step>`` (zero-padded to 10 digits) — a crash
  mid-save can never corrupt the latest restorable checkpoint.
* **Layout**: one ``.npy`` per leaf, named by its path in the state
  (``params/layers/wq/w`` -> ``params__layers__wq__w.npy``: dict keys,
  list indices and ``TrainState``'s field names, joined by ``/``), plus
  ``manifest.json`` (``step``, ``extra``, each leaf's shape and dtype).
  A checkpoint the reference's ``CheckpointManager`` wrote restores here,
  and the other way round. numpy has no bfloat16: a bf16 leaf is written
  as float32 (a widening that loses no bit) and narrowed again on
  restore; a reference checkpoint's bf16 leaves (2-byte voids to numpy)
  are read bit for bit.
* **Exact-resume**: the manifest carries the data-pipeline cursor
  (seed, step); pipelines are stateless functions of (seed, step), so the
  post-restore batch stream is bit-identical.
* **Async**: ``save(..., blocking=False)`` copies every leaf to the host
  synchronously, then writes on a background thread — training overlaps
  checkpoint I/O.
* **GC**: keep-last-k.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.convert import _tensor_from_numpy

__all__ = ["CheckpointManager"]


def _flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves of a nested dict / list / NamedTuple by their '/' paths (a
    dict's keys in sorted order, as ``jax.tree_util`` flattens them)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                       else str(k)))
    return out


def _unflatten(template: Any, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten(v, leaves, f"{prefix}/{k}" if prefix else k)
            for k, v in zip(template._fields, template)])
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return leaves[prefix]


def _host_copy(leaf) -> np.ndarray:
    """A leaf as a numpy array the writer owns (bf16 widened to f32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(
        self,
        step: int,
        state: Any,
        extra: Optional[Dict] = None,
        blocking: bool = True,
    ) -> None:
        """Snapshot ``state`` (a TrainState or any nested dict / list of
        tensors) at ``step``."""
        self.wait()  # one in-flight async save at a time
        flat = {k: _host_copy(v)
                for k, v in _flatten_with_paths(state).items()}
        manifest = {
            "step": step,
            "extra": extra or {},
            "leaves": {
                k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                for k, v in flat.items()
            },
        }

        def _write():
            tmp = os.path.join(self.dir, f"tmp-{step}")
            final = os.path.join(self.dir, f"step-{step:010d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for k, v in flat.items():
                np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"), v)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)  # atomic publish
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.dir, f"step-{s:010d}"), ignore_errors=True
            )

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None):
        """Restore into the structure of ``template``: each leaf on the
        template leaf's device and in its dtype (the template's values are
        never read). Returns (state, manifest)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step-{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for k, like in _flatten_with_paths(template).items():
            a = np.load(os.path.join(d, k.replace("/", "__") + ".npy"))
            if tuple(a.shape) != tuple(like.shape):
                raise ValueError(f"{k}: checkpoint {a.shape}, template "
                                 f"{tuple(like.shape)}")
            leaves[k] = _tensor_from_numpy(a, like.device, like.dtype)
        return _unflatten(template, leaves), manifest
