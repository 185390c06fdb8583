"""Checkpointing: atomic, resumable (incl. data-loader state) — the port of
``repro.checkpoint.manager``, with its on-disk layout and contract:

- **Atomic**: write to ``<dir>/tmp.<step>`` then ``rename`` to
  ``<dir>/step_%010d`` — a crash mid-save never corrupts the latest
  checkpoint.
- **Self-describing**: ``manifest.json`` records ``step``, ``time``, the
  loader state (three integers plus the stream's fingerprint give exact
  mid-epoch resume), ``extra`` (e.g. the arch and the data spec),
  ``num_arrays`` and ``ext_dtypes``.
- **Arrays**: one ``arrays.npz`` of the state's leaves, keyed by their
  ``/``-joined paths; bf16 leaves are stored as uint16 views (numpy has no
  bf16) and named in ``ext_dtypes``.
- **Async**: ``save(..., blocking=False)`` copies the leaves to host memory
  first, then writes on a background thread.
- **keep_n GC**: old checkpoints are pruned after a successful save.

A state is a tree of nested dicts whose leaves are tensors, numpy arrays or
Python numbers.  :meth:`CheckpointManager.restore` reads one back in a
template's structure, checks every key and shape, and gives each leaf the
template leaf's type: a tensor on the template's device and dtype, or a
numpy array.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "flatten_tree", "unflatten_tree"]

_SEP = "/"


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{_SEP}{k}" if prefix else str(k))
    else:
        yield prefix, tree


def flatten_tree(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """(arrays, extended-dtype map) of a tree's leaves, copied to host
    memory.  bf16 tensors become uint16 views recorded as ``bfloat16``."""
    flat, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                dtypes[key] = "bfloat16"
                arr = t.view(torch.int16).numpy().view(np.uint16)
            else:
                arr = t.numpy()
        else:
            arr = np.array(leaf)
        flat[key] = arr
    return flat, dtypes


def _restore_leaf(arr: np.ndarray, ext: Optional[str], like):
    if ext == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return t.numpy().astype(like.dtype, copy=False)
    return t.numpy()


def unflatten_tree(template, flat: dict[str, np.ndarray], ext_dtypes: Optional[dict] = None):
    """``template``'s structure filled from ``flat``; raises ``KeyError`` on
    a missing leaf and ``ValueError`` on a shape mismatch or an extra leaf."""
    ext_dtypes = ext_dtypes or {}
    used = set()

    def fill(node, prefix: str):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}{_SEP}{k}" if prefix else str(k)) for k, v in node.items()}
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        arr = flat[prefix]
        want = tuple(np.shape(node))
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {prefix}: ckpt {arr.shape} vs model {want}")
        used.add(prefix)
        return _restore_leaf(arr, ext_dtypes.get(prefix), node)

    out = fill(template, "")
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"checkpoint leaves not in the template: {extra[:5]}")
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def save(
        self,
        step: int,
        state: Any,
        *,
        loader_state: Optional[dict] = None,
        extra: Optional[dict] = None,
        blocking: bool = True,
    ) -> None:
        # Snapshot to host synchronously (cheap vs step time); write async.
        flat, dtypes = flatten_tree(state)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "loader_state": loader_state,
            "extra": extra or {},
            "num_arrays": len(flat),
            "ext_dtypes": dtypes,
        }
        if blocking:
            self._write(step, flat, manifest)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, manifest), daemon=True
            )
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, manifest: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = os.path.join(self.dir, f"tmp.{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> tuple[Any, dict]:
        """(tree in ``template``'s structure, manifest) of ``step`` (the
        latest by default)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return unflatten_tree(template, flat, manifest.get("ext_dtypes", {})), manifest
