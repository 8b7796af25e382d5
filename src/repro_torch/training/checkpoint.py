"""Checkpoint save/restore with an async writer — PyTorch port of
``repro.training.checkpoint``, with its on-disk layout:

  <dir>/step_<N>/
    MANIFEST.json         — {"step": N, "leaves": [{"path", "file", "shape",
                             "dtype"}], "meta": {...}}
    leaf_<i>.npy          — one array per tree leaf (np.save)

The leaves are in the reference's flattening order with its paths
(``tree.leaves_with_paths``), so ``leaf_<i>`` is the same leaf in both
packages and a checkpoint written by one restores in the other. A bfloat16
leaf is written as its 16-bit pattern under the header ``np.save`` writes
for a JAX bfloat16 array (descr ``<V2``, 2-byte void, which ``np.load``
returns as ``|V2``), with ``"dtype": "bfloat16"`` in the manifest: the
same bytes as the reference's file. ``restore`` reads a void or 16-bit
integer leaf back as bfloat16 through its bits.

A save copies every leaf to the host (a snapshot: the state may change
in place as soon as ``save`` returns), writes into ``step_<N>.tmp`` and
renames it into place (an atomic publish), then keeps the newest ``keep``
steps. The async writer moves the file writes off the training thread;
``wait()`` joins outstanding writes and raises the first error a write
met. ``restore(step, like, device)`` rebuilds the tree shaped like
``like`` (any tree of tensors, ``meta`` ones included) with each leaf in
``like``'s dtype on ``device`` — the card unless ``device="cpu"``; it
takes the place of the reference's ``shardings``.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _dev
from repro_torch.training.tree import leaves, leaves_with_paths, unflatten

Params = Any


def _to_numpy(leaf) -> np.ndarray:
    """A copy of a leaf on the host; bfloat16 as its bits in a ``|V2``
    array. A copy even for a leaf already on the host, since the train step
    updates the state in place while the async writer still holds it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _save(path: str, arr: np.ndarray) -> None:
    if arr.dtype != np.dtype("V2"):
        np.save(path, arr, allow_pickle=False)
        return
    with open(path, "wb") as fh:
        np.lib.format.write_array_header_1_0(fh, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        fh.write(np.ascontiguousarray(arr).tobytes())


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16" or arr.dtype == np.dtype("V2"):
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


class AsyncWriter:
    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._errors: List[BaseException] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                item()
            except Exception as e:      # surfaced at wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def submit(self, fn) -> None:
        self._q.put(fn)

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self.writer = AsyncWriter() if async_write else None

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Params,
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Snapshot ``tree`` at ``step``. Returns the checkpoint path."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "meta": meta or {}, "leaves": []}
        arrays = []
        for i, (kp, leaf) in enumerate(leaves_with_paths(tree)):
            arr = _to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            manifest["leaves"].append({
                "path": kp, "file": fname,
                "shape": list(arr.shape), "dtype": _dtype_name(arr)})
            arrays.append((os.path.join(tmp, fname), arr))

        def commit():
            for f, a in arrays:
                _save(f, a)
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as fh:
                json.dump(manifest, fh)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.replace(tmp, path)          # atomic publish
            self._gc()

        if self.writer:
            self.writer.submit(commit)
        else:
            commit()
        return path

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        if self.writer:
            self.writer.wait()

    # ------------------------------------------------------------------ #
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Params,
                device: _dev.DeviceLike = None) -> Params:
        """Rebuild the tree saved at ``step``, shaped like ``like``, each
        leaf cast to its dtype in ``like`` and placed on ``device``."""
        dev = _dev.resolve(device)
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "MANIFEST.json")) as fh:
            manifest = json.load(fh)
        flat_like = leaves(like)
        if len(flat_like) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint {path} holds "
                             f"{len(manifest['leaves'])} leaves, the tree "
                             f"{len(flat_like)}")
        out = []
        for entry, tmpl in zip(manifest["leaves"], flat_like):
            arr = np.load(os.path.join(path, entry["file"]),
                          allow_pickle=False)
            t = _from_numpy(arr, entry["dtype"])
            out.append(t.to(device=dev, dtype=tmpl.dtype))
        return unflatten(like, out)

    def restore_meta(self, step: int) -> Dict[str, Any]:
        path = os.path.join(self.dir, f"step_{step:08d}", "MANIFEST.json")
        with open(path) as fh:
            return json.load(fh)["meta"]
