"""The program's spans and counters: one home for what a trace reads.

``span(name)`` marks a stage. While a ``torch.profiler`` session runs it
enters ``record_function(name)``, so the stage sits in the kineto trace
on the same clock as the device's activities, and each kernel can be
given to the span around the runtime call that launched it. Otherwise
it returns one shared null context after a single flag check: no
``record_function``, no allocation.

``counting()`` opens a window of counters and yields a dict that holds
each counter's total once the window closes. ``count(name, value)``
adds a host int or a 0-d device tensor under a lock (the serving engine
and the sharded probe pool call from threads); device values are summed
and read once, when the window closes, so counting makes the host wait
for nothing. With no window open ``count`` returns at once, and a site
whose value would be a new tensor tests ``counting_open()`` first, so
that no tensor is made and no kernel launched. Kernel launch counts are
``repro_torch.kernels.launch_counts``'s.

Spans (children nested under their parent; the search names are the
ones ``chip_smoke.py``'s ``search_split`` reads):

* ``search.encode``: ``Searcher.encode_queries``.
* ``search.index``: ``Searcher.search_encoded``, around the index's
  ``search_batch``. Inside it: ``search.centroid_scores``,
  ``search.probe_members``, ``search.code_gather``,
  ``search.plaid_probe`` and ``search.prune`` (``core/plaid.py``,
  candidates); ``search.packed_gather`` and ``search.maxsim_packed``
  (``core/plaid.py``, the packed rerank) or ``search.maxsim_rerank``
  (``core/maxsim.py``, the reconstruction store's); ``search.topk``
  (``core/index.py``).
* ``build.encode`` and ``build.pool``: ``Indexer``'s stage clock
  (``retrieval/indexer.py``), once an encode batch.
* ``build.index``: ``Indexer.build``'s index stage. Inside it:
  ``build.kmeans`` (``train_centroids``) and ``build.codec``
  (``train_codec``) in ``core/index.py``; ``build.codes`` (the codec's
  ``encode``) and ``build.ivf`` (``build_inverted_lists``) in
  ``build_plaid_index``; ``build.views`` (``_build_views``).
* ``build.save``: ``Indexer.build``'s save stage.

Counters:

* ``search.encode_chunks``: one a chunk of ``Searcher.encode_queries``
  (up to ``encode_batch`` queries), on either path.
* ``search.encode_replays``: one a chunk replayed from the searcher's
  CUDA graph (``models.colbert.QueryGraph``); over
  ``search.encode_chunks``, how often the graph engages.
* ``search.encode_captures``: one a capture of that graph (the first
  chunk at a width, and the first after a parameter is stored anew).
  All three are counted outside the captured region.
* ``search.batches``: one a ``search.index``.
* ``search.host_reads``: one a blocking device-to-host read of the
  search path: the device path's ``int(counts.max())``
  (``core/plaid.py``), the host path's two reads of its probes, and the
  two reads of ``topk_with_pads`` (``core/maxsim.py``); three a
  device-path batch.
* ``search.probe_slots``, ``search.probe_candidates``: where the prune
  engages, the slots ``plaid_probe`` scores (queries x slate width, a
  host int) and the valid candidates among them (a device count on the
  device path).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

_NULL = nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler session runs, else a
    shared null context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL


class _Window:
    def __init__(self):
        self.lock = threading.Lock()
        self.host: Dict[str, int] = {}
        self.device: Dict[str, List[torch.Tensor]] = {}

    def add(self, name: str, value) -> None:
        with self.lock:
            if isinstance(value, torch.Tensor):
                self.device.setdefault(name, []).append(value.detach())
            else:
                self.host[name] = self.host.get(name, 0) + int(value)

    def totals(self) -> Dict[str, int]:
        """Each counter's total: the device values summed on their
        device and read in one transfer a device."""
        with self.lock:
            out = dict(self.host)
            groups: Dict[torch.device, Dict[str, list]] = {}
            for name, values in self.device.items():
                for v in values:
                    groups.setdefault(v.device, {}).setdefault(
                        name, []).append(v.reshape(()).to(torch.int64))
        for named in groups.values():
            sums = torch.stack([torch.stack(vs).sum()
                                for vs in named.values()])
            for name, s in zip(named, sums.tolist()):
                out[name] = out.get(name, 0) + int(s)
        return out


_window: Optional[_Window] = None


def counting_open() -> bool:
    """Whether a counting window is open (the flag a count site whose
    value would be a new tensor tests first)."""
    return _window is not None


def count(name: str, value) -> None:
    """Add ``value`` (a host int or a 0-d device tensor) to counter
    ``name`` of the open window; nothing without one."""
    w = _window
    if w is not None:
        w.add(name, value)


@contextmanager
def counting() -> Iterator[Dict[str, int]]:
    """A window of counters: yields a dict that holds each counter's
    total once the window closes. One window at a time."""
    global _window
    if _window is not None:
        raise RuntimeError("a counting window is already open")
    w = _window = _Window()
    out: Dict[str, int] = {}
    try:
        yield out
    finally:
        _window = None
        out.update(w.totals())
