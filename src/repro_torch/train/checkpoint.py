"""Checkpoints in the reference's on-disk format
(``src/repro/train/checkpoint.py``), so either package restores the
other's.

Layout per step:
    <dir>/step_<N>.tmp/            (write in progress)
        shard_<i>.npz              (arrays keyed a<i>, in sorted path order)
        manifest.json              (step, extra, entries: path -> shard,
                                    key, shape, dtype; n_shards)
    <dir>/step_<N>/                (os.replace when complete)
    <dir>/latest                   (the last published step)

A tree is a nested dict / list of arrays or tensors; paths are
``tree_paths``' ``a/b/0/c`` and dict nodes keyed 0..n-1 come back as
lists. ``save`` copies every array to the host before it returns (the
caller goes on updating its tensors in place), then writes on a
background thread; ``wait`` joins it. Only the newest ``max_to_keep``
steps are kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.train.params import host, listify, tree_paths


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return listify(tree)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 shard_mb: int = 256, async_write: bool = True):
        self.dir = directory
        self.max_to_keep = max_to_keep
        self.shard_bytes = shard_mb * 1024 * 1024
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -------------------------------------------------------------- save
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        host_arrays = {p: host(a) for p, a in tree_paths(tree)}
        if self.async_write:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_async,
                args=(step, host_arrays, extra or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, host_arrays, extra or {})

    def wait(self) -> None:
        """Join the writer; raises what a background write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_async(self, step, host_arrays, extra) -> None:
        try:
            self._write(step, host_arrays, extra)
        except BaseException as e:          # re-raised by wait()
            self._error = e

    def _write(self, step: int, host_arrays: Dict[str, np.ndarray],
               extra: Dict) -> None:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.isdir(final):          # step already published: idempotent
            return
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "entries": {},
                    "n_shards": 0}
        shard, shard_sz, shard_id = {}, 0, 0

        def flush():
            nonlocal shard, shard_sz, shard_id
            if shard:
                np.savez(os.path.join(tmp, f"shard_{shard_id}.npz"), **shard)
                shard_id += 1
                shard, shard_sz = {}, 0

        for i, (path, arr) in enumerate(sorted(host_arrays.items())):
            key = f"a{i}"
            manifest["entries"][path] = {
                "shard": shard_id, "key": key,
                "shape": list(arr.shape), "dtype": str(arr.dtype)}
            shard[key] = arr
            shard_sz += arr.nbytes
            if shard_sz >= self.shard_bytes:
                flush()
        flush()
        manifest["n_shards"] = shard_id
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)           # atomic publish
        with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "latest.tmp"),
                   os.path.join(self.dir, "latest"))
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        marker = os.path.join(self.dir, "latest")
        if os.path.exists(marker):
            with open(marker) as f:
                s = int(f.read().strip())
            if os.path.isdir(os.path.join(self.dir, f"step_{s}")):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Tuple[int, Any, Dict]:
        """Returns (step, tree of host numpy arrays, extra); the latest
        step by default."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for i in range(manifest["n_shards"]):
            with np.load(os.path.join(d, f"shard_{i}.npz")) as shard:
                for path, e in manifest["entries"].items():
                    if e["shard"] == i:
                        flat[path] = shard[e["key"]]
        return step, _unflatten(flat), manifest.get("extra", {})
