"""Versioned on-disk index artifacts, the format both packages share.

Counterpart of ``src/repro/core/persist.py`` (``FORMAT_VERSION = 1``)
for monolithic flat, hnsw and plaid indexes and for the pooled cascade:
an artifact is a directory of

    manifest.json     format_version, generation, kind, then for an
                      index: backend, dim, n_docs, params, (codec_bits);
                      (hnsw: entry, max_level);
                      for a cascade: dim, coarse_factor, fine_factor,
                      candidates, doc_maxlen; and the payload table
                      {name: file, dtype, shape, bytes}
    <payload>.<token>.npy   one numpy array per tensor

The manifest is the single source of truth: a missing key, a missing or
truncated payload, a dtype/shape/bytes mismatch or another
``format_version`` raises :class:`IndexFormatError`. Saving compacts
dead docs out of the payloads (zero-length spans, flagged in ``live``),
so doc ids survive; an hnsw graph keeps its deleted token nodes (they
route the walk). Payload dtypes are the reference's: packed words
``uint32`` (the port's tensors carry the same bits as int32),
assignments ``int32``, offsets / ids ``int64``, ``live`` bool, vectors
and codec tables ``float32``. Loading reads the payloads (memory-mapped
with ``mmap=True``) and copies them onto the index's device.

Sharded artifacts are not ported (ROADMAP queue 1, item 2).
"""
from __future__ import annotations

import itertools
import json
import os
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.spec import INDEX_PARAM_KEYS as _PARAM_KEYS
from repro_torch.device import DeviceLike, resolve_device

FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"

# small payload mutated in place: always copied off the mapped file
_ALWAYS_COPY = ("live",)


class IndexFormatError(Exception):
    """Artifact on disk cannot be read safely by this code version."""


# ---------------------------------------------------------------------------
# Manifest + payload I/O
# ---------------------------------------------------------------------------
def _require(mapping: Dict[str, Any], key: str, where: str) -> Any:
    if key not in mapping:
        raise IndexFormatError(f"missing required key {key!r} in {where}")
    return mapping[key]


def artifact_generation(path: str) -> int:
    """Publish counter of the artifact at ``path`` (0 if none)."""
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as fh:
            return int(json.load(fh).get("generation", 0))
    except (OSError, ValueError, json.JSONDecodeError):
        return 0


def write_artifact(path: str, meta: Dict[str, Any],
                   payloads: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Write payload .npy files + manifest.json; returns the manifest.

    Payloads land under per-save unique file names, the manifest rename
    is the one commit point, and files the new manifest does not name
    are deleted only after it is published, so a crash leaves the
    previous version loadable. Each publish bumps ``generation``."""
    os.makedirs(path, exist_ok=True)
    generation = int(meta.get("generation",
                              artifact_generation(path) + 1))
    token = uuid.uuid4().hex[:8]
    table = {}
    for name, arr in payloads.items():
        arr = np.ascontiguousarray(arr)
        fn = f"{name}.{token}.npy"
        tmp = os.path.join(path, fn + ".tmp")
        with open(tmp, "wb") as fh:
            np.save(fh, arr)
        os.replace(tmp, os.path.join(path, fn))
        table[name] = {"file": fn, "dtype": str(arr.dtype),
                       "shape": list(arr.shape), "bytes": int(arr.nbytes)}
    manifest = dict(meta)
    manifest["format_version"] = FORMAT_VERSION
    manifest["generation"] = generation
    manifest["payloads"] = table
    tmp = os.path.join(path, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=2, sort_keys=True)
    os.replace(tmp, os.path.join(path, MANIFEST_NAME))   # atomic publish
    live_files = {e["file"] for e in table.values()}
    for fn in os.listdir(path):                          # stale versions
        if ((fn.endswith(".npy") or fn.endswith(".tmp"))
                and fn not in live_files):
            try:
                os.remove(os.path.join(path, fn))
            except OSError:
                pass
    return manifest


def read_manifest(path: str) -> Dict[str, Any]:
    """Load and validate manifest.json (version gate, required keys)."""
    mf = os.path.join(path, MANIFEST_NAME)
    if not os.path.isfile(mf):
        raise IndexFormatError(f"no {MANIFEST_NAME} in {path!r}: not an "
                               f"index artifact directory")
    try:
        with open(mf) as fh:
            manifest = json.load(fh)
    except (json.JSONDecodeError, OSError) as e:
        raise IndexFormatError(f"unreadable manifest in {path!r}: {e}")
    ver = _require(manifest, "format_version", mf)
    if ver != FORMAT_VERSION:
        raise IndexFormatError(
            f"format_version {ver!r} not supported (this reader handles "
            f"{FORMAT_VERSION}); re-save the index with the matching code")
    _require(manifest, "kind", mf)
    _require(manifest, "payloads", mf)
    return manifest


def load_payloads(path: str, manifest: Dict[str, Any],
                  mmap: bool = True) -> Dict[str, np.ndarray]:
    """Every payload the manifest names, validated against its recorded
    dtype/shape/bytes. ``mmap=True`` maps files read-only."""
    out: Dict[str, np.ndarray] = {}
    for name, entry in manifest["payloads"].items():
        for key in ("file", "dtype", "shape", "bytes"):
            _require(entry, key, f"payload {name!r}")
        fp = os.path.join(path, entry["file"])
        if not os.path.isfile(fp):
            raise IndexFormatError(f"payload {name!r}: file "
                                   f"{entry['file']!r} is missing")
        mode = "r" if (mmap and name not in _ALWAYS_COPY) else None
        try:
            arr = np.load(fp, mmap_mode=mode)
        except (ValueError, OSError) as e:
            raise IndexFormatError(
                f"payload {name!r}: corrupt or truncated file "
                f"{entry['file']!r} ({e})")
        if (list(arr.shape) != list(entry["shape"])
                or str(arr.dtype) != entry["dtype"]
                or int(arr.nbytes) != int(entry["bytes"])):
            raise IndexFormatError(
                f"payload {name!r}: on-disk {arr.dtype}{list(arr.shape)} "
                f"does not match manifest "
                f"{entry['dtype']}{entry['shape']}")
        if name in _ALWAYS_COPY:
            arr = np.array(arr)
        out[name] = arr
    return out


def artifact_bytes(path_or_manifest) -> int:
    """Serialized payload size, the sum of the manifest's bytes."""
    manifest = (path_or_manifest if isinstance(path_or_manifest, dict)
                else read_manifest(path_or_manifest))
    return sum(int(e["bytes"]) for e in manifest["payloads"].values())


def _tensor(arr: np.ndarray, device: torch.device,
            view: Optional[np.dtype] = None) -> torch.Tensor:
    """A payload (possibly a read-only map) as a tensor on ``device``."""
    a = np.array(arr)
    return torch.from_numpy(a if view is None else a.view(view)).to(device)


# ---------------------------------------------------------------------------
# Payloads of each part of an index
# ---------------------------------------------------------------------------
def _compact_spans(live: np.ndarray, lens: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-vector keep mask + CSR offsets where dead docs become
    zero-length spans (doc ids stay, their rows stop costing bytes)."""
    rows_keep = np.repeat(np.asarray(live, bool), lens)
    new_lens = np.where(live, lens, 0)
    offsets = np.zeros(len(new_lens) + 1, np.int64)
    np.cumsum(new_lens, out=offsets[1:])
    return rows_keep, offsets


def _docstore_payloads(store, prefix: str = "") -> Dict[str, np.ndarray]:
    rows_keep, offsets = _compact_spans(store.live, store.doc_lengths())
    flat = store.flat.cpu().numpy()[rows_keep]
    return {f"{prefix}flat": np.asarray(flat, np.float32),
            f"{prefix}offsets": offsets,
            f"{prefix}live": np.asarray(store.live, bool)}


def _docstore_from(payloads: Dict[str, np.ndarray], prefix: str,
                   doc_maxlen: int, device: torch.device):
    from repro_torch.core.docstore import DocStore
    return DocStore.from_arrays(_tensor(payloads[f"{prefix}flat"], device),
                                payloads[f"{prefix}offsets"],
                                payloads[f"{prefix}live"],
                                doc_maxlen=doc_maxlen)


def codec_payloads(codec) -> Dict[str, np.ndarray]:
    return {f"codec_{k}": getattr(codec, k).float().cpu().numpy()
            for k in ("centroids", "cutoffs", "values")}


def codec_from_payloads(payloads: Dict[str, np.ndarray], bits: int,
                        device: torch.device):
    from repro_torch.core.quantization import ResidualCodec
    return ResidualCodec(
        centroids=_tensor(payloads["codec_centroids"], device),
        cutoffs=_tensor(payloads["codec_cutoffs"], device),
        values=_tensor(payloads["codec_values"], device),
        bits=int(bits))


def _hnsw_payloads(index) -> Dict[str, np.ndarray]:
    """The graph in CSR form (edge counts [levels, n] and the edges in
    level-major, node order). Deleted token nodes keep their vectors and
    edges: they route the walk, and dropping them would change the
    graph a loaded index searches."""
    h = index._hnsw
    n = len(h.levels)
    counts = np.zeros((len(h.graph), n), np.int64)
    for lv, rows in enumerate(h.graph):
        counts[lv, :len(rows)] = [len(r) for r in rows]
    edges = np.fromiter(
        itertools.chain.from_iterable(r for rows in h.graph for r in rows),
        np.int64, count=int(counts.sum()))
    deleted = np.fromiter(sorted(h.deleted), np.int64, count=len(h.deleted))
    return {"hnsw_vectors": np.asarray(h.vectors, np.float32),
            "hnsw_levels": np.asarray(h.levels, np.int64),
            "hnsw_edge_counts": counts,
            "hnsw_edges": edges,
            "hnsw_deleted": deleted,
            "hnsw_vec2doc": np.asarray(index._hnsw_vec2doc, np.int64)}


def _hnsw_from(index, payloads, manifest):
    from repro_torch.core.hnsw import HNSW
    h_meta = _require(manifest, "hnsw", "hnsw artifact")
    for name in ("hnsw_levels", "hnsw_edge_counts", "hnsw_edges",
                 "hnsw_deleted", "hnsw_vec2doc"):
        _require(payloads, name, "hnsw artifact")
    return HNSW.from_state(
        dim=index.dim, m=index.hnsw_m,
        ef_construction=index.hnsw_ef_construction,
        vectors=np.array(payloads["hnsw_vectors"]),
        levels=payloads["hnsw_levels"],
        edge_counts=payloads["hnsw_edge_counts"],
        edges=payloads["hnsw_edges"],
        deleted=payloads["hnsw_deleted"],
        entry=int(_require(h_meta, "entry", "hnsw meta")),
        max_level=int(_require(h_meta, "max_level", "hnsw meta")))


def _plaid_payloads(index) -> Dict[str, np.ndarray]:
    """Compacted PLAID stack: codec, packed residuals, IVF lists; dead
    docs' rows dropped, their ids kept as zero-length spans."""
    from repro_torch.core.ivf import build_inverted_lists
    p = index._plaid
    live = index._live()
    rows_keep, doc_offsets = _compact_spans(live, np.diff(p.doc_offsets))
    assignments = p.assignments.cpu().numpy()[rows_keep]
    codes = p.codes.cpu().numpy().view(np.uint32)[rows_keep]
    ivf = build_inverted_lists(assignments, p.codec.n_centroids)
    out = codec_payloads(p.codec)
    out.update({"assignments": assignments.astype(np.int32),
                "codes": codes,
                "vec2doc": np.repeat(np.arange(index.n_docs, dtype=np.int64),
                                     np.diff(doc_offsets)),
                "doc_offsets": doc_offsets,
                "ivf_ids": ivf.ids.astype(np.int64),
                "ivf_offsets": ivf.offsets.astype(np.int64),
                "live": np.asarray(live, bool)})
    return out


def index_payloads(index) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(meta, payloads) of a MultiVectorIndex: what ``save_index``
    writes."""
    meta: Dict[str, Any] = {
        "kind": "multi_vector_index",
        "backend": index.backend,
        "dim": int(index.dim),
        "n_docs": int(index.n_docs),
        "params": {k: getattr(index, k) for k in _PARAM_KEYS},
    }
    payloads: Dict[str, np.ndarray] = {}
    if index.backend in ("flat", "hnsw"):
        payloads.update(_docstore_payloads(index._store))
        if index.backend == "hnsw" and index._hnsw is not None:
            payloads.update(_hnsw_payloads(index))
            meta["hnsw"] = {"entry": (-1 if index._hnsw.entry is None
                                      else int(index._hnsw.entry)),
                            "max_level": int(index._hnsw.max_level)}
    elif index._plaid is not None:
        meta["codec_bits"] = int(index._plaid.codec.bits)
        payloads.update(_plaid_payloads(index))
    return meta, payloads


def serialized_nbytes(index) -> int:
    """Bytes ``save_index`` would put on disk, without writing."""
    _, payloads = index_payloads(index)
    return sum(int(a.nbytes) for a in payloads.values())


def save_index(index, path: str,
               extra_meta: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Write a MultiVectorIndex artifact directory; returns the manifest."""
    meta, payloads = index_payloads(index)
    if extra_meta:
        meta.update(extra_meta)
    return write_artifact(path, meta, payloads)


def load_index(path: str, mmap: bool = True, device: DeviceLike = None):
    """Reconstruct a flat, hnsw or plaid MultiVectorIndex (written by
    either package) onto ``device``."""
    from repro_torch.core.index import MultiVectorIndex

    manifest = read_manifest(path)
    if manifest["kind"] != "multi_vector_index":
        raise IndexFormatError(f"expected kind 'multi_vector_index', "
                               f"found {manifest['kind']!r}")
    backend = _require(manifest, "backend", path)
    dim = int(_require(manifest, "dim", path))
    params = dict(_require(manifest, "params", path))
    unknown = set(params) - set(_PARAM_KEYS)
    if unknown:
        raise IndexFormatError(f"unknown index params {sorted(unknown)}")
    index = MultiVectorIndex(dim=dim, backend=backend,
                             device=resolve_device(device), **params)
    payloads = load_payloads(path, manifest, mmap=mmap)
    if not payloads:                    # empty index: nothing was stored
        return index
    if backend in ("flat", "hnsw"):
        index._store = _docstore_from(payloads, "", index.doc_maxlen,
                                      index.device)
        index.deleted = set(np.nonzero(~index._store.live)[0].tolist())
        if backend == "hnsw" and "hnsw_vectors" in payloads:
            index._hnsw = _hnsw_from(index, payloads, manifest)
            index._hnsw_vec2doc = np.array(payloads["hnsw_vec2doc"])
    else:
        _plaid_from(index, payloads, manifest)
    return index


def _plaid_from(index, payloads, manifest) -> None:
    from repro_torch.core.ivf import InvertedLists
    from repro_torch.core.plaid import PLAIDIndex
    for name in ("assignments", "codes", "vec2doc", "doc_offsets",
                 "ivf_ids", "ivf_offsets", "live"):
        _require(payloads, name, "plaid artifact")
    dev = index.device
    codec = codec_from_payloads(
        payloads, _require(manifest, "codec_bits", "plaid artifact"), dev)
    index._plaid = PLAIDIndex(
        codec=codec,
        ivf=InvertedLists(offsets=np.array(payloads["ivf_offsets"]),
                          ids=np.array(payloads["ivf_ids"])),
        assignments=_tensor(payloads["assignments"], dev),
        codes=_tensor(payloads["codes"], dev, view=np.int32),
        vec2doc=np.array(payloads["vec2doc"]),
        doc_offsets=np.array(payloads["doc_offsets"]),
        doc_maxlen=index.doc_maxlen)
    index.deleted = set(np.nonzero(~payloads["live"])[0].tolist())


# ---------------------------------------------------------------------------
# CascadeIndex <-> artifact
# ---------------------------------------------------------------------------
def cascade_payloads(cascade) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(meta, payloads) of a CascadeIndex: what ``save_cascade`` writes,
    both pool levels as docstore payloads under ``coarse_`` / ``fine_``."""
    meta = {"kind": "cascade_index",
            "dim": int(cascade.dim),
            "coarse_factor": int(cascade.coarse_factor),
            "fine_factor": int(cascade.fine_factor),
            "candidates": int(cascade.candidates),
            "doc_maxlen": int(cascade.doc_maxlen)}
    payloads = _docstore_payloads(cascade._coarse, "coarse_")
    payloads.update(_docstore_payloads(cascade._fine, "fine_"))
    return meta, payloads


def save_cascade(cascade, path: str,
                 extra_meta: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    meta, payloads = cascade_payloads(cascade)
    if extra_meta:
        meta.update(extra_meta)
    return write_artifact(path, meta, payloads)


def load_cascade(path: str, mmap: bool = True, device: DeviceLike = None):
    """Reconstruct a CascadeIndex (written by either package) onto
    ``device``."""
    from repro_torch.retrieval.cascade import CascadeIndex
    manifest = read_manifest(path)
    if manifest["kind"] != "cascade_index":
        raise IndexFormatError(f"expected kind 'cascade_index', found "
                               f"{manifest['kind']!r}")
    cascade = CascadeIndex(
        dim=int(_require(manifest, "dim", path)),
        coarse_factor=int(_require(manifest, "coarse_factor", path)),
        fine_factor=int(_require(manifest, "fine_factor", path)),
        candidates=int(_require(manifest, "candidates", path)),
        doc_maxlen=int(_require(manifest, "doc_maxlen", path)),
        device=resolve_device(device))
    payloads = load_payloads(path, manifest, mmap=mmap)
    for level in ("coarse_", "fine_"):
        for name in ("flat", "offsets", "live"):
            _require(payloads, level + name, "cascade artifact")
    cascade._coarse = _docstore_from(payloads, "coarse_", cascade.doc_maxlen,
                                     cascade.device)
    cascade._fine = _docstore_from(payloads, "fine_", cascade.doc_maxlen,
                                   cascade.device)
    return cascade


def load_artifact(path: str, mmap: bool = True, device: DeviceLike = None):
    """Load the index artifact at ``path``, dispatching on the manifest
    ``kind``: the loader behind ``Searcher.from_dir``."""
    kind = read_manifest(path)["kind"]
    if kind == "multi_vector_index":
        return load_index(path, mmap=mmap, device=device)
    if kind == "cascade_index":
        return load_cascade(path, mmap=mmap, device=device)
    if kind == "sharded_index":
        raise NotImplementedError(
            "sharded_index artifacts are not ported yet (ROADMAP queue 1)")
    raise IndexFormatError(f"artifact kind {kind!r} at {path!r} is not a "
                           f"searchable index")
