"""Checkpoints with a crash-safe commit protocol (the port of
``repro/checkpoint/manager.py``).

- **Atomicity**: a checkpoint is written to ``step_XXXXXXXXXX.tmp/`` and
  renamed to ``step_XXXXXXXXXX/`` only after every array and the manifest
  are fsync'd; a ``COMMITTED`` marker is written last.  Restore only
  considers directories with the marker, so a process dying mid-save
  never corrupts a restore.
- **Integrity**: the manifest stores a SHA-256 digest a leaf; restore
  verifies it and raises on a mismatch.
- **Placement**: arrays are saved from the host; restore puts each leaf
  on the device and in the dtype of the matching leaf of ``like``.
- **Async**: ``CheckpointManager.save_async`` copies the tree to host
  memory on the caller's thread, then writes on a background thread (the
  train loop blocks only if a previous save is still in flight); an error
  of the write surfaces on the next ``wait()``.
- **Retention**: the newest ``keep`` checkpoints are kept.

Format: one ``.npy`` a leaf plus ``manifest.json`` (names, dtypes,
shapes, digests, opaque user metadata such as the data step).  A tree is
the port's: dicts, lists and tuples (the optimizers' NamedTuples) of
tensors; a leaf's name is its path joined by ``__`` (a dict key, a list
index or a NamedTuple field), and None is an empty subtree.  numpy has no
bfloat16, so a bf16 leaf is stored as its int16 bit pattern, its manifest
dtype ``bfloat16``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_MARKER = "COMMITTED"
_MANIFEST = "manifest.json"
_BF16 = "bfloat16"


def _leaf_paths(tree, prefix: Tuple[str, ...] = ()) -> List[tuple]:
    """[(name, leaf)] in the tree's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [("__".join(prefix) or "leaf", tree)]
    return [x for k, node in items
            for x in _leaf_paths(node, prefix + (str(k),))]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` in order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


@dataclasses.dataclass(frozen=True)
class _HostArray:
    """A leaf already copied to the host (``save_async``'s snapshot)."""
    arr: np.ndarray
    dtype: str


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and the dtype name the manifest records: a
    copy, since the train loop goes on writing the params and moments in
    place while a background save reads the snapshot."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _write_synced(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "metadata": metadata or {}}
    for name, leaf in _leaf_paths(tree):
        arr, dtype = ((leaf.arr, leaf.dtype) if isinstance(leaf, _HostArray)
                      else _host(leaf))
        fname = f"{name}.npy"
        _write_synced(os.path.join(tmp, fname), lambda f: np.save(f, arr))
        manifest["leaves"].append({
            "name": name, "file": fname, "dtype": dtype,
            "shape": list(arr.shape), "sha256": _digest(arr)})
    _write_synced(os.path.join(tmp, _MANIFEST),
                  lambda f: f.write(json.dumps(manifest).encode()))
    _write_synced(os.path.join(tmp, _MARKER), lambda f: f.write(b"ok"))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _committed_steps(directory: str) -> List[int]:
    return sorted(int(d[5:]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp")
                  and os.path.exists(os.path.join(directory, d, _MARKER)))


def latest_step(directory: str) -> Optional[int]:
    """Newest *committed* checkpoint step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, like: Any, *,
                       verify: bool = True) -> Any:
    """Restore into the structure of ``like``: each leaf on the device
    and in the dtype of ``like``'s leaf of the same name."""
    path = os.path.join(directory, f"step_{step:010d}")
    if not os.path.exists(os.path.join(path, _MARKER)):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    by_name = {entry["name"]: entry for entry in manifest["leaves"]}
    out = []
    for name, leaf in _leaf_paths(like):
        entry = by_name[name]
        arr = np.load(os.path.join(path, entry["file"]))
        if verify and _digest(arr) != entry["sha256"]:
            raise IOError(f"checkpoint digest mismatch for {name}")
        t = torch.from_numpy(arr)
        if entry["dtype"] == _BF16:
            t = t.view(torch.bfloat16)
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return _unflatten(like, iter(out))


def read_metadata(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step:010d}", _MANIFEST)
    with open(path) as f:
        return json.load(f)["metadata"]


class CheckpointManager:
    """Async save + retention + resume."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[dict] = None):
        """Copy to the host on the caller's thread, write in the
        background."""
        self.wait()
        host_tree = {name: _HostArray(*_host(leaf))
                     for name, leaf in _leaf_paths(tree)}

        def _run():
            try:
                save_checkpoint(self.directory, step, host_tree, metadata)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in _committed_steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    def restore_latest(self, like: Any):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like)
