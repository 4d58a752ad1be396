"""What a traced run reads besides the host clock.

- ``Smi``: one ``nvidia-smi`` process sampling the utilisation of every
  card of the cell every 100 ms over the window, the cards' readings
  pooled (their mean is the mean over the cards). The card counts a sample period busy while
  any kernel runs, kernels inside CUDA-graph conditional bodies too, which
  the profiler does not see. Each reading covers the sample period before
  it (up to a second on this card), so readings that arrive in the
  window's first second, which still cover the set-up before it, are
  left out.
- ``device_summary``: the ``torch.profiler`` trace of the window reduced
  to the device's busy seconds (the union of every kernel, copy and set
  on the card), seconds by kernel name, and the longest idle gaps named by
  what the host was doing in them.
- ``card``: the card's name and power limit (the lowest of the cell's
  cards).
"""
from __future__ import annotations

import subprocess
import threading
import time

import torch


def _cards(count: int) -> str:
    """``nvidia-smi -i``'s list of the cell's cards: ``0``, ``0,1,2,3``."""
    return ",".join(str(i) for i in range(count))


def _smi(query: str, count: int = 1) -> list:
    """One field's value on each of the first ``count`` cards."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits", "-i",
                          _cards(count)],
                         capture_output=True, text=True, timeout=30)
    return [s.strip() for s in out.stdout.strip().splitlines()]


def card(count: int) -> dict:
    """The contract's ``device`` record (without the peak), with the
    power limit in watts beside it: the lowest of the ``count`` cards'."""
    try:
        limit = min(float(v) for v in _smi("power.limit", count))
    except (OSError, ValueError, subprocess.SubprocessError):
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "power_limit_w": limit}


class Smi:
    """``nvidia-smi --query-gpu=utilization.gpu -lms 100`` on the first
    ``count`` cards over a window: ``samples(t0, t1)`` are the readings,
    every card's, that arrived between the host clock's ``t0 + lag`` and
    ``t1``."""

    LAG_S = 1.0

    def __init__(self, count: int = 1):
        self.count = count

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100", "-i",
             _cards(self.count)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.readings = []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.readings.append((time.perf_counter(),
                                      float(line.strip())))
            except ValueError:
                pass

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.reader.join(timeout=30)
        return False

    def samples(self, t0: float, t1: float) -> list:
        return [v for t, v in self.readings if t0 + self.LAG_S <= t <= t1]


def _union(intervals: list) -> tuple:
    """Total length of the union and the gaps between its pieces."""
    total, gaps = 0.0, []
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def device_summary(prof, path_kernels: list, top: int = 10) -> dict:
    """Reduce a profiler run: ``busy_s``, ``by_name`` (device seconds per
    kernel or copy name), ``path_s`` (seconds of the kernels whose names
    hold one of ``path_kernels``), ``device_ops`` and ``idle_gaps`` (the
    ``top`` largest, in seconds)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, ev.name))
        elif ev.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, ev.name))
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    busy, gaps = _union([(s, e) for s, e, _ in dev])
    path_s = sum(v for k, v in by_name.items()
                 if any(p in k for p in path_kernels))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    if path_s == 0.0:
        ops = [["no kernel of the path recorded by the profiler", 0.0]] + \
            [list(kv) for kv in ops[:top - 1]]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host.sort()
    named = []
    for a, b in longest:
        mid = 0.5 * (a + b)
        best = None
        for s, e, name in host:
            if s > mid:
                break
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        named.append([best[2] if best else "host idle", (b - a) * 1e-6])
    return {"busy_s": busy * 1e-6, "by_name": by_name, "path_s": path_s,
            "device_ops": [list(kv) for kv in ops], "idle_gaps": named}
