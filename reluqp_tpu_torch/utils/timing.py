"""Timing and profiling helpers for asynchronous CUDA work.

PyTorch returns before the card finishes, so a host clock measures only
the enqueue unless the timed region ends in a synchronization. Every helper
here ends its timed region with ``torch.cuda.synchronize`` on the devices
of the CUDA tensors it is given (``block_until_ready``), and does not
synchronize for CPU tensors. ``time_fn_events`` times on the card itself,
with CUDA events. ``two_point_step_time`` cancels a fixed per-call overhead
by timing a short and a long chain; a delta it cannot measure is NaN,
never a clamped number. ``span`` names a stretch of the program's host
work on the profiler's timeline, and ``trace`` records that timeline.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch

__all__ = ["Timer", "time_fn", "time_fn_events", "time_fn_fetched", "fetch",
           "block_until_ready", "two_point_step_time",
           "two_point_step_time_or_coarse", "trace", "span", "entropy_rng",
           "min_delta", "chain_timer"]


def entropy_rng() -> np.random.RandomState:
    """A ``RandomState`` seeded from ``os.urandom``, for timed inputs that
    no earlier run has used."""
    return np.random.RandomState(np.frombuffer(os.urandom(4), np.uint32)[0])


def _leaves(x) -> List[torch.Tensor]:
    """The tensors of a nested tuple / list / dict / NamedTuple, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _leaves(item)]
    return []


def block_until_ready(x):
    """Wait for the work that produces ``x``'s CUDA tensors (one
    ``torch.cuda.synchronize`` per device they live on); CPU tensors need
    no wait. Returns ``x``."""
    for dev in {t.device for t in _leaves(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x


def fetch(x) -> float:
    """The sum of ``x``'s first tensor as a Python float: a read that
    cannot finish before the work that produced it."""
    leaves = _leaves(x)
    if not leaves:
        raise ValueError("fetch: no tensor in the result")
    return float(leaves[0].double().sum())


def time_fn_fetched(fn: Callable, args_maker: Callable[[int], tuple],
                    warmup: int = 1, reps: int = 5) -> Dict[str, float]:
    """Wall time of ``fn(*args_maker(i))``, each call ended by ``fetch``;
    ``args_maker(i)`` gives call i's inputs (fresh values per call)."""
    for i in range(warmup):
        fetch(fn(*args_maker(-1 - i)))
    ts = []
    for i in range(reps):
        args = args_maker(i)
        t0 = time.perf_counter()
        fetch(fn(*args))
        ts.append(time.perf_counter() - t0)
    return _stats(ts)


def _stats(ts) -> Dict[str, float]:
    ts = sorted(ts)
    return dict(best=ts[0], median=ts[len(ts) // 2], mean=sum(ts) / len(ts),
                reps=len(ts))


@dataclass
class Timer:
    """Accumulating named wall-clock timer with device synchronization."""

    times: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time a block; ``sync`` (optional tensors) is waited for before
        the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                block_until_ready(sync)
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            n = len(ts)
            out[name] = dict(n=n, total=sum(ts), mean=sum(ts) / n,
                             min=min(ts), max=max(ts))
        return out


def time_fn(fn: Callable, *args, warmup: int = 1, reps: int = 10,
            **kwargs) -> Dict[str, float]:
    """Best / median / mean wall seconds of ``fn(*args, **kwargs)``, its
    output waited for inside the timed region, after ``warmup`` calls."""
    for _ in range(warmup):
        block_until_ready(fn(*args, **kwargs))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block_until_ready(fn(*args, **kwargs))
        ts.append(time.perf_counter() - t0)
    return _stats(ts)


def time_fn_events(fn: Callable, *args, warmup: int = 1, reps: int = 10,
                   device=None, **kwargs) -> Dict[str, float]:
    """Best / median / mean seconds of ``fn(*args, **kwargs)`` on the card:
    a CUDA event recorded on the current stream before and after each
    call, read after a synchronization. Raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn_events needs a CUDA device")
    device = torch.device("cuda") if device is None else torch.device(device)
    for _ in range(warmup):
        fn(*args, **kwargs)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
        fn(*args, **kwargs)
        end.record(torch.cuda.current_stream(device))
        pairs.append((start, end))
    torch.cuda.synchronize(device)
    return _stats([s.elapsed_time(e) * 1e-3 for s, e in pairs])


def min_delta(timed_lo: Callable[[], float],
              timed_hi: Callable[[], float], reps: int = 5) -> float:
    """``min(long samples) − min(short samples)`` over ``reps`` pairs.

    Host noise (a shared core, a page fault) only adds time, so each side's
    minimum converges to its true time; a median of paired deltas would
    stay high while most pairs are hit, and a minimum of paired deltas can
    go negative when only the short call is."""
    t_los, t_his = [], []
    for _ in range(reps):
        t_los.append(timed_lo())
        t_his.append(timed_hi())
    return min(t_his) - min(t_los)


def chain_timer(make_chain: Callable[[int], Callable],
                args_of: Callable[[object], tuple],
                fresh_input: Callable[[int], object]
                ) -> Callable[[object, int], float]:
    """Adapt a chain builder to ``two_point_step_time``'s ``timed(x, n)``.

    ``make_chain(n)`` returns a callable that runs an n-rep chain whose
    result depends on every rep; ``args_of(x)`` maps an input value to its
    arguments. Each chain length is built once and run once untimed on its
    own fresh input (``fresh_input(-n)``) before its first timed call; a
    timed call ends in ``fetch``."""
    fns: Dict[int, Callable] = {}

    def timed(x, n: int) -> float:
        f = fns.get(n)
        if f is None:
            f = fns[n] = make_chain(n)
            fetch(f(*args_of(fresh_input(-n))))
        t0 = time.perf_counter()
        fetch(f(*args_of(x)))
        return time.perf_counter() - t0

    return timed


def two_point_step_time(timed: Callable[[object, int], float],
                        fresh_input: Callable[[int], object],
                        n_lo: int, n_hi: int, reps: int = 5,
                        noise_s: float = 2e-3,
                        jitter_s: float = 0.05) -> float:
    """Seconds per step by a two-point fit: ``(t(n_hi) − t(n_lo)) /
    (n_hi − n_lo)``, each side the least of ``reps`` (``min_delta``), so a
    fixed per-call cost cancels.

    ``timed(x, n)`` runs an n-step chain on input ``x`` and returns its
    seconds, its work finished; ``fresh_input(j)`` gives call j's input.
    Callers build both lengths before timing. When the delta does not
    clear ``jitter_s``, the long chain is stretched 8× (one untimed pass
    first) and the fit repeated; a delta still below ``noise_s`` is NaN —
    never a clamped number."""
    if n_hi <= n_lo:
        raise ValueError(f"need n_hi > n_lo, got {n_lo} >= {n_hi}")
    ctr = [0]

    def fresh():
        ctr[0] += 1
        return fresh_input(ctr[0])

    def measure(nh):
        return min_delta(lambda: timed(fresh(), n_lo),
                         lambda: timed(fresh(), nh), reps)

    span = n_hi - n_lo
    d = measure(n_hi)
    if d < jitter_s:
        n_big = n_lo + span * 8
        timed(fresh(), n_big)        # build pass, untimed
        span = n_big - n_lo
        d = measure(n_big)
        if d < noise_s:
            return float("nan")
    return d / span


def two_point_step_time_or_coarse(timed, fresh_input, n_lo, n_hi, **kw):
    """``two_point_step_time`` with a finite fallback for JSON output:
    ``(sec_per_step, method)``. Where the fit is NaN, the long chain's time
    with its fixed cost included, ``timed(x, n_hi) / n_hi`` — an upper
    bound — tagged ``"coarse"``; a fitted value is tagged
    ``"two_point"``."""
    d = two_point_step_time(timed, fresh_input, n_lo, n_hi, **kw)
    if math.isfinite(d):
        return d, "two_point"
    return timed(fresh_input(64), n_hi) / n_hi, "coarse"


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that names a stretch of the program's host work
    ``reluqp::<name>`` while a ``torch.profiler`` records (``trace``, or any
    other profiler): a host range on the profiler's timeline, beside the
    card's kernels and copies on the same clock. It is recorded as an
    operator range (``cpu_op``), not a ``record_function`` annotation, so
    the profiler mirrors no ``gpu_user_annotation`` of it onto the card's
    timeline, where a reader of the card's events would take it for device
    work. While none records it is one shared no-op context, after a
    single flag test."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast("reluqp::" + name)


@contextlib.contextmanager
def trace(log_dir: str = None):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a
    card); on exit writes the Chrome trace ``<log_dir>/trace.json``
    (``log_dir`` defaults to ``reluqp_trace`` under the temporary
    directory). Yields the profiler, whose ``key_averages()`` sums the
    kernels by name. The trace holds the program's ``span`` ranges:
    ``reluqp::rollout`` around a rollout call and, inside it, each
    segment's ``rollout.stage`` (its inputs made into the kernel's
    arguments), ``rollout.launch``, ``rollout.read`` (the one wait on the
    card) and ``rollout.finish``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "reluqp_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()   # the block's kernels end inside
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
