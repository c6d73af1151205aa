"""Fault-tolerant checkpointing, as in ``repro/train/checkpoint.py``, in
its on-disk format, so that a checkpoint written by either package
restores in the other.

Every leaf is saved as a full host numpy array in one ``.npz``
(``step_%010d.npz``), bf16 as f32 (npz has no bf16), under the JAX
package's key strings: ``jax.tree_util.keystr`` paths joined by ``/``,
a dict key as ``['name']`` (keys sorted), a ``NamedTuple`` field as
``.name`` and a sequence index as ``[i]``; for example
``['opt']/.master/['embed']``.  A JSON manifest beside it holds the
step, the sorted keys and the same integrity tag (a sha256 over each
key and the first 4096 bytes of its array).  ``restore(step, like)``
casts each leaf to ``like``'s dtype and device.

Writes are atomic (tmp + rename), kept ``keep`` deep, and off the
training thread (a background writer), so a crash mid-write never
corrupts the latest checkpoint.  ``restore(..., shardings=)`` re-shards
each leaf onto a mesh, as the JAX package's does with ``NamedSharding``
leaves: here ``models/sharding.NamedSharding(mesh, spec)`` leaves, which
give each restored tensor its DTensor placements.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any

import numpy as np
import torch


def _children(tree):
    """(key string, child) pairs in JAX's flattening order, or None for
    a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            t = tree.detach().cpu()
            arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        else:
            arr = np.asarray(tree)
        return {prefix: arr}
    out = {}
    for key, child in kids:
        out.update(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return out


def _rebuild(like, data, prefix: str = ""):
    kids = _children(like)
    if kids is None:
        arr = data[prefix]
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                      dtype=like.dtype)
        return arr
    vals = [_rebuild(c, data, f"{prefix}/{k}" if prefix else k)
            for k, c in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> str:
        arrays = _flatten(tree)  # host copy happens here, synchronously
        if self.async_write:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays)
        return os.path.join(self.dir, f"step_{step:010d}.npz")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrays: dict):
        path = os.path.join(self.dir, f"step_{step:010d}.npz")
        tmp = path + ".tmp"
        np.savez(tmp, **arrays)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
        digest = hashlib.sha256()
        for k in sorted(arrays):
            digest.update(k.encode())
            digest.update(arrays[k].tobytes()[:4096])
        manifest = {"step": step, "keys": sorted(arrays),
                    "sha": digest.hexdigest(), "time": time.time()}
        mtmp = path + ".json.tmp"
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, path + ".json")
        self._gc()

    def _gc(self):
        for step in sorted(self._list())[:-self.keep]:
            for suffix in (".npz", ".npz.json"):
                p = os.path.join(self.dir, f"step_{step:010d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)

    def _list(self):
        return [int(f[5:-4]) for f in os.listdir(self.dir)
                if f.endswith(".npz") and f.startswith("step_")]

    # ------------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = self._list()
        return max(steps) if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Restore into the structure of ``like``: each tensor leaf with
        its dtype and device (bf16 rounds the stored f32, which holds a
        saved bf16 exactly); re-sharded onto a mesh by ``shardings``, a
        tree matching ``like`` of ``NamedSharding`` leaves (None: a leaf
        as it is), if given."""
        path = os.path.join(self.dir, f"step_{step:010d}.npz")
        with open(path + ".json") as f:
            manifest = json.load(f)
        if manifest["step"] != step:
            raise ValueError(f"{path}: the manifest says step "
                             f"{manifest['step']}, not {step}")
        with np.load(path) as data:
            tree = _rebuild(like, data)
        return tree if shardings is None else _reshard(tree, shardings)


def _reshard(tree, shardings):
    """Each leaf of ``tree`` as a DTensor with its ``NamedSharding``'s
    placements (a None sharding leaves it as it is)."""
    from repro_torch.models.sharding import distribute
    kids = _children(tree)
    if kids is None:
        if shardings is None:
            return tree
        mesh, spec = shardings
        return distribute(tree, spec, mesh)
    vals = [_reshard(c, s) for (_, c), (_, s) in
            zip(kids, _children(shardings) or [(k, None) for k, _ in kids])]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)
