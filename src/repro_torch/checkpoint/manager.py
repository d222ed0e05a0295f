"""Checkpoint / restart in the reference's on-disk format
(``repro/checkpoint/manager.py``), so that a checkpoint written by either
package restores in the other.

* A checkpoint is a directory ``step_N`` holding ``arrays.npz`` — one
  array per leaf of the state tree, keyed by its path (dict keys as they
  are, a NamedTuple field as ``.name``, joined by ``/``), bfloat16 stored
  as its raw uint16 words — and ``meta.json`` with the step, the time and
  each leaf's dtype name.
* Atomic: written to ``step_N.tmp``, fsynced and renamed into place.
* Asynchronous: tensors are copied to host memory on the caller's thread
  (CPU tensors too: their copy shares nothing with the live state),
  written by a background thread; an error surfaces at the next ``save``
  or ``wait``.
* Retention: the latest ``keep`` checkpoints stay, older ones go.

State trees are nested dicts, NamedTuples (the optimizer's state and its
int8 moments) and tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` in the reference's key spelling."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], join(k)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(_flatten_with_paths(getattr(tree, name),
                                           join("." + name)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, leaf in enumerate(tree):
            out.update(_flatten_with_paths(leaf, join(i)))
        return out
    return {prefix: tree}


def _to_numpy(t) -> np.ndarray:
    """A host copy of a tensor as numpy, never sharing its storage (the
    optimizer updates CPU tensors in place while an async save writes);
    bfloat16 as its uint16 words (dtype recorded beside it)."""
    if not isinstance(t, torch.Tensor):
        return np.array(t, copy=True)
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def _from_numpy(arr: np.ndarray, want: Optional[str]) -> torch.Tensor:
    """The stored array as a tensor of its recorded dtype (bfloat16 from
    its raw 16-bit words)."""
    if want == "bfloat16" and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot ``state`` to host memory now; write it in the
        background when ``async_save``."""
        self.wait()
        flat = _flatten_with_paths(state)
        store = {k: _to_numpy(v) for k, v in flat.items()}
        dtypes = {k: _dtype_name(v) for k, v in flat.items()}
        meta = dict(metadata or {})
        meta.update({"step": step, "time": time.time(), "dtypes": dtypes})

        def _write():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"), **store)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.isdir(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)       # the atomic commit point
                self._gc()
            except BaseException as e:       # surfaced on the next save/wait
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {err!r}")

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: Optional[int]) -> str:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return os.path.join(self.dir, f"step_{step}")

    def restore(self, template, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``template``: each leaf takes the
        template leaf's dtype and device."""
        path = self._path(step)
        with open(os.path.join(path, "meta.json")) as f:
            dtypes = json.load(f).get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            def build(tree, prefix=""):
                def join(key):
                    return f"{prefix}/{key}" if prefix else str(key)
                if isinstance(tree, dict):
                    return {k: build(v, join(k)) for k, v in tree.items()}
                if isinstance(tree, tuple) and hasattr(tree, "_fields"):
                    return type(tree)(*(build(getattr(tree, n), join("." + n))
                                        for n in tree._fields))
                t = _from_numpy(arrays[prefix], dtypes.get(prefix))
                if isinstance(tree, torch.Tensor):
                    return t.to(device=tree.device, dtype=tree.dtype)
                return t
            return build(template)

    def load_arrays(self, step: Optional[int] = None):
        """A checkpoint as a flat ``{path: tensor}`` dict and its meta."""
        path = self._path(step)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        dtypes = meta.get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            out = {k: _from_numpy(arrays[k], dtypes.get(k))
                   for k in arrays.files}
        return out, meta

    def metadata(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)
