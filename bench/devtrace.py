"""What a profiler trace says about the device: busy time, the operations
that took most of it, and the longest idle gaps by what the host was doing.

The trace is the Chrome trace that ``torch.profiler`` exports: device
events are its ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` entries, host
events its ``cpu_op``, ``user_annotation`` and ``python_function`` entries
(times in microseconds). The window is the host annotation ``WINDOW``.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")

Interval = Tuple[str, float, float]  # (name, start us, end us)


def records(chrome: dict) -> Dict[str, object]:
    """Device and host intervals and the window from an exported trace."""
    events = chrome["traceEvents"] if isinstance(chrome, dict) else chrome
    device: List[Interval] = []
    host: List[Interval] = []
    window: Optional[Tuple[float, float]] = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            device.append((e.get("name", "?"), ts, ts + dur))
        elif cat in HOST_CATS:
            if cat == "user_annotation" and e.get("name") == WINDOW:
                window = (ts, ts + dur)
            else:
                host.append((e.get("name", "?"), ts, ts + dur))
    if window is None:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    return {"device": device, "host": host, "window": window}


def _busy(device: List[Interval], window) -> List[Tuple[float, float]]:
    """The union of the device intervals inside the window, sorted."""
    w0, w1 = window
    spans = sorted((max(a, w0), min(b, w1)) for _, a, b in device if b > w0 and a < w1)
    merged: List[Tuple[float, float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def summary(rec: Dict[str, object], top: int = 10) -> Dict[str, object]:
    """``window_s``, ``busy_s``, per-name device seconds (``device_s``), the
    ``top`` device operations and the ``top`` idle gaps by host operation."""
    w0, w1 = rec["window"]
    busy = _busy(rec["device"], (w0, w1))
    device_s: Dict[str, float] = {}
    for name, a, b in rec["device"]:
        if b > w0 and a < w1:
            device_s[name] = device_s.get(name, 0.0) + (min(b, w1) - max(a, w0)) / 1e6
    gaps = []
    edge = w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = b
    if w1 > edge:
        gaps.append((edge, w1))
    host = sorted(rec["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_host: Dict[str, float] = {}
    for a, b in gaps:
        name = _host_at(host, starts, (a + b) / 2)
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
    order = lambda d: sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_s": device_s,
            "device_ops": [[n[:160], s] for n, s in order(device_s)],
            "idle_gaps": [[n[:160], s] for n, s in order(by_host)]}


def _host_at(host: List[Interval], starts: List[float], t: float, scan: int = 4096) -> str:
    """The innermost host operation running at ``t``: of those that cover it,
    the one that started last (host operations nest)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        if host[j][2] > t:
            return host[j][0]
    return "host idle"


def seconds_of(device_s: Dict[str, float], names) -> float:
    """Device seconds of the operations whose names contain any of ``names``."""
    return sum(s for n, s in device_s.items() if any(k in n for k in names))
