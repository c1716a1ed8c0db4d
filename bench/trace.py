"""The traced run's reading of ``torch.profiler``.

``profiler()`` records the card's activities (kernels, copies, sets)
and the host's operations over the measured window, which the harness
marks with a ``bench.window`` range. ``summary`` reduces the trace to:

* ``busy_s``: the length of the union of the device's activities inside
  the window (seconds in which an operation ran on the card);
* ``window_s``: the window's length on the trace's clock;
* ``kernel_s``: device seconds by kernel name, inside the window;
* ``device_ops``: the ten kernels with the most device time;
* ``idle_gaps``: the ten longest stretches inside the window with
  nothing on the device, each named by the innermost host operation
  running at its midpoint (``host idle`` where there is none).
"""
from __future__ import annotations

import numpy as np

WINDOW = "bench.window"
NAME_CHARS = 120


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def summary(prof) -> dict:
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW
           and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev, host = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.name() != WINDOW:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    kernel_s: dict = {}
    spans = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) * 1e-9
        spans.append((s, t))
    spans.sort()
    merged = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-9
    edges = [w0] + [x for st in merged for x in st] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    if host:
        hs = np.array([h[0] for h in host], np.int64)
        he = np.array([h[1] for h in host], np.int64)
    named = []
    for length, start in gaps:
        mid = start + length // 2
        label = "host idle"
        if host:
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if len(inside):
                label = host[inside[np.argmin((he - hs)[inside])]][2]
        named.append([_short(label), length * 1e-9])
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=(w1 - w0) * 1e-9, kernel_s=kernel_s,
                device_ops=[[_short(n), s] for n, s in top],
                idle_gaps=named)


def kernel_seconds(kernel_s: dict, *names: str) -> float:
    """Device seconds of the kernels whose names hold any of ``names``."""
    return sum(s for n, s in kernel_s.items() if any(k in n for k in names))
