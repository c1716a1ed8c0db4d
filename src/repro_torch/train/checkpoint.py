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
lists. ``save`` copies every tensor to the host before it returns (the
caller goes on updating its tensors in place; a numpy leaf is taken as
it is, as the reference takes it), then writes on a background thread;
``wait`` joins it; its shards are written by ``WRITERS`` threads at
once. Only the newest ``max_to_keep`` steps are kept.
``restore`` reads each array straight from its member of the
uncompressed ``.npz`` into its own memory.

Over a mesh (``distributed=True``, every rank of the default group
holding a manager on the same directory) every rank takes part in the
gathers of a ``DTensor``'s full array (one leaf at a time), rank 0
alone keeps and writes them (``writes``), and ``wait`` ends in a
barrier, so no rank reads ``latest`` before it is there.
``restore(placements=..., mesh=...)`` lays each array it names out on
the current mesh as it is read, each rank taking its own slice (the
reference's ``shardings``: the elastic path, any number of ranks
reading what any number wrote).
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.train.params import host, listify, tree_paths

WRITERS = 8                  # threads writing a checkpoint's shards


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return listify(tree)


def _npz_members(path: str):
    """(key, array) of every member of an ``.npz``: a stored member (as
    ``np.savez`` writes them) read with one ``readinto`` from its place
    in the file (``np.load`` reads it through ``zipfile`` in 256 KiB
    pieces, checksummed), a compressed one through ``zipfile``."""
    fmt = np.lib.format
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for info in z.infolist():
            key = info.filename[:-len(".npy")]
            f.seek(info.header_offset + 26)      # the local file header
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            read_header = info.compress_type == zipfile.ZIP_STORED and {
                (1, 0): fmt.read_array_header_1_0,
                (2, 0): fmt.read_array_header_2_0}.get(fmt.read_magic(f))
            if not read_header:
                with z.open(info) as m:
                    yield key, fmt.read_array(m)
                continue
            shape, fortran, dtype = read_header(f)
            flat = np.empty(int(np.prod(shape)) * dtype.itemsize, np.uint8)
            if f.readinto(flat) != flat.size:
                raise EOFError(f"{path}: {key} cut short")
            yield key, flat.view(dtype).reshape(
                shape, order="F" if fortran else "C")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 shard_mb: int = 256, async_write: bool = True,
                 distributed: bool = False):
        self.dir = directory
        self.max_to_keep = max_to_keep
        self.shard_bytes = shard_mb * 1024 * 1024
        self.async_write = async_write
        self.distributed = distributed
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    @property
    def writes(self) -> bool:
        """True where this rank keeps and writes what it saves: every
        manager without a mesh, rank 0 over one."""
        if not self.distributed:
            return True
        import torch.distributed as dist
        return dist.get_rank() == 0

    # -------------------------------------------------------------- save
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        """Over a mesh every rank calls it with the same tree: a rank
        that does not write gathers each ``DTensor`` leaf with the
        others and drops it (a tree of None leaves, ``to_tree(...,
        keep=False)``, is taken as it is)."""
        keep = self.writes
        host_arrays = {p: a if isinstance(a, np.ndarray) else host(a, keep)
                       for p, a in tree_paths(tree)}
        self.wait()
        if not keep:
            return
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write_async,
                args=(step, host_arrays, extra or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, host_arrays, extra or {})

    def wait(self, barrier: bool = True) -> None:
        """Join the writer; raises what a background write raised. Over
        a mesh, then a barrier of every rank (``barrier=False``: none,
        for a rank that stops on an error while the others may be gone)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if self.distributed and barrier:
            import torch.distributed as dist
            dist.barrier()

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
        manifest = {"step": step, "extra": extra, "entries": {}}
        shards, size = [], self.shard_bytes   # a full shard closes
        for i, (path, arr) in enumerate(sorted(host_arrays.items())):
            if size >= self.shard_bytes:
                shards.append({})
                size = 0
            key = f"a{i}"
            manifest["entries"][path] = {
                "shard": len(shards) - 1, "key": key,
                "shape": list(arr.shape), "dtype": str(arr.dtype)}
            shards[-1][key] = arr
            size += arr.nbytes
        manifest["n_shards"] = len(shards)

        def write_shard(i):
            np.savez(os.path.join(tmp, f"shard_{i}.npz"), **shards[i])
        # the shards at once: each member's checksum and copy into the
        # page cache run without the GIL
        with ThreadPoolExecutor(max(1, min(WRITERS, len(shards)))) as pool:
            list(pool.map(write_shard, range(len(shards))))
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

    def restore(self, step: Optional[int] = None, placements=None,
                mesh=None) -> Tuple[int, Any, Dict]:
        """Returns (step, tree, extra); the latest step by default. The
        tree holds host numpy arrays, but where ``placements`` (path ->
        the DTensor placements of that array on ``mesh``, e.g.
        ``sharding/params.py`` ``checkpoint_placements``) names a path,
        a ``DTensor`` over ``mesh`` holding this rank's slice."""
        if placements is not None and mesh is None:
            raise ValueError("placements need the mesh they lay out on")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if placements:
            from repro_torch.sharding.api import from_host
        where = {(e["shard"], e["key"]): path
                 for path, e in manifest["entries"].items()}
        flat = {}
        for i in range(manifest["n_shards"]):
            for key, a in _npz_members(os.path.join(d, f"shard_{i}.npz")):
                path = where.get((i, key))
                if path is None:
                    continue
                flat[path] = (from_host(a, mesh, placements[path])
                              if placements and path in placements else a)
        return step, _unflatten(flat), manifest.get("extra", {})
