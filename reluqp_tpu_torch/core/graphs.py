"""Check windows as CUDA graphs: one capture per window shape, replayed.

A check window of the solve loops (``core.iteration.solve_loop``,
``core.batched``) is a fixed sequence of device work between two host
reads: the chunk kernel, the residuals, the ρ walk, the convergence and
certificate updates and, under a process group, the collective. On
``cuda`` each window runs as one replay of a CUDA graph, so a window costs
the host one graph launch, the bundle's copy and its one synchronisation.
This is the port's counterpart of the JAX package's compiled
``lax.while_loop`` bodies (``reluqp_tpu/core/iteration.py`` ``solve_loop``,
``reluqp_tpu/core/batched.py``), minus the device-side exit: the host still
reads one bundle per window and decides from it.

What a graph may touch:

- the window's state and the solve's per-solve vectors (``g``, bounds,
  biases, row maps), copied once at the solve's entry into static buffers
  this cache owns (``stage``), so that a later solve with new vectors
  replays the same graph;
- the solver's operands (banks, H, A, ρ ladders, residual operators),
  named in the window's key by identity (``sig``: address, shape,
  strides, dtype), so that a new operand captures anew;
- host values baked into the launches (the window's length, the tier,
  whether ρ moves, the tolerances), which are in the key too.

The first use of a key runs the window eagerly on the capture stream (it
sets up cuBLAS's workspace for that stream and loads the kernels); the
second use captures it and replays it; every later use replays. All the
graphs of one cache share one memory pool (a new one once the cache holds
no graph, as after ``clear``); everything a window keeps is
written into static buffers allocated outside the pool, so the graphs'
pool memory holds only intermediates and replays may come in any order. A
capture that fails raises: nothing runs the window eagerly in its place.

A replay calls no Python wrapper, so kernel wrappers count their launches
through ``on_launch``: the hooks a capture records run once per replay.

On the CPU the loops run their windows eagerly unless the cache is given a
``capture`` factory (the tests' stand-in: it calls the recorded window
again on the same buffers at every replay, which is a graph's binding).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Optional

import torch

__all__ = ["WindowGraphs", "on_launch", "sig", "window_graphs",
           "run_window"]

_recording: Optional[list] = None
# graphs a cache keeps (least recently used first out): a solver's windows
# take a few keys per (rows, settings); stale ones follow a new operand
_MAX_WINDOWS = 64


def on_launch(hook: Callable[[], None]) -> None:
    """A launch's host-side bookkeeping (a launch counter): run ``hook``
    now, or, while a window is being captured, once per replay of it
    instead (the capture itself launches nothing)."""
    if _recording is None:
        hook()
    else:
        _recording.append(hook)


def sig(obj):
    """What a captured launch bakes in of ``obj``: a tensor's address,
    shape, strides, dtype and device (a tensor of another identity needs
    another graph), tuples element by element, anything else itself."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", obj.data_ptr(), tuple(obj.shape), obj.stride(),
                obj.dtype, obj.device)
    if isinstance(obj, (tuple, list)):
        return tuple(sig(o) for o in obj)
    return obj


class _CudaGraph:
    """One window captured in a ``torch.cuda.CUDAGraph`` on ``stream``,
    its memory from the pool ``pool`` (a ``graph_pool_handle``)."""

    def __init__(self, fn, stream, pool):
        self.graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool)
            try:
                fn()
            finally:
                self.graph.capture_end()
        cur.wait_stream(stream)

    def replay(self):
        self.graph.replay()


class _Window:
    __slots__ = ("graph", "hooks", "uses")

    def __init__(self):
        self.graph, self.hooks, self.uses = None, (), 0


class WindowGraphs:
    """A solver's captured check windows, their static buffers and pool.

    ``capture(fn, stream, pool)`` makes a replayable capture of ``fn``:
    ``None`` (the package's default) captures a CUDA graph on ``cuda`` and
    leaves the CPU eager; the tests pass a stand-in. ``captures`` and
    ``replays`` count what this cache did, ``capture_seconds`` the host
    time its captures took."""

    def __init__(self, capture=None):
        self._capture = capture
        self._windows: OrderedDict = OrderedDict()
        self._buffers: dict = {}
        self._host: dict = {}
        self._stream = self._pool = None
        self._live = 0          # captured graphs held (sharing the pool)
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def enabled(self, device) -> bool:
        """Whether windows on ``device`` run through this cache."""
        return self._capture is not None or torch.device(device).type == "cuda"

    def clear(self) -> None:
        """Drop every graph and buffer (a new setup: new operands)."""
        self._windows.clear()
        self._buffers.clear()
        self._host.clear()
        self._live, self._pool = 0, None

    def keys(self) -> list:
        """The keys of the windows this cache holds, oldest first."""
        return list(self._windows)

    # ---------------------------------------------------------------- #
    def buffer(self, name: str, shape, dtype, device) -> torch.Tensor:
        """The static tensor ``name`` of this shape and dtype (made, empty,
        on first use)."""
        key = (name, tuple(shape), dtype, torch.device(device))
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(shape, dtype=dtype,
                                                   device=device)
        return buf

    def stage(self, name: str, t):
        """``t`` copied into the static tensor ``name`` (None stays None)."""
        if t is None:
            return None
        buf = self.buffer(name, t.shape, t.dtype, t.device)
        if buf is not t:
            buf.copy_(t)
        return buf

    def read(self, t: torch.Tensor) -> list:
        """The window's one host read of ``t``: one copy into a pinned host
        buffer and one synchronisation on ``cuda``."""
        if not t.is_cuda:
            return t.tolist()
        key = (tuple(t.shape), t.dtype)
        host = self._host.get(key)
        if host is None:
            host = self._host[key] = torch.empty(t.shape, dtype=t.dtype,
                                                 pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return host.tolist()

    # ---------------------------------------------------------------- #
    def _side(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if self._pool is None:
            # torch's device and pinned-host allocators drop a graph pool
            # with the last graph captured into it, and refuse a capture
            # into it after that: a new pool once none is left
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _dropped(self, w: _Window) -> None:
        """Bookkeeping for a window leaving the cache."""
        if w.graph is not None:
            self._live -= 1
            if self._live == 0:
                self._pool = None

    def run(self, key, fn: Callable[[], None], device) -> None:
        """Run the window ``fn`` (which reads and writes static tensors
        only) under ``key``: eagerly at the key's first use, captured at
        its second, replayed from then on."""
        w = self._windows.get(key)
        if w is None:
            w = self._windows[key] = _Window()
            while len(self._windows) > _MAX_WINDOWS:
                self._dropped(self._windows.popitem(last=False)[1])
        else:
            self._windows.move_to_end(key)
        w.uses += 1
        if w.uses == 1:
            self._eager(fn, device)
            return
        if w.graph is None:
            self._record(w, fn, device)
        w.graph.replay()
        for hook in w.hooks:
            hook()
        self.replays += 1

    def _eager(self, fn, device):
        if self._capture is not None:
            fn()
            return
        side = self._side(device)
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)

    def _record(self, w: _Window, fn, device):
        global _recording
        t0 = time.perf_counter()
        outer, _recording = _recording, []
        try:
            if self._capture is not None:
                w.graph = self._capture(fn, None, None)
            else:
                side = self._side(device)
                w.graph = _CudaGraph(fn, side, self._pool)
            w.hooks = tuple(_recording)
            self._live += 1
        finally:
            _recording = outer
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0


def window_graphs(graphs, device) -> Optional[WindowGraphs]:
    """The cache a loop runs its windows through: ``graphs`` as given (a
    solver's), a fresh one for this call when ``None``, none (eager) when
    ``False`` or where the cache does not run ``device``'s windows."""
    if graphs is False:
        return None
    if graphs is None:
        graphs = WindowGraphs()
    return graphs if graphs.enabled(device) else None


def run_window(graphs: Optional[WindowGraphs], key, fn, state, bundle_buf):
    """One check window ``fn(state) -> (new state, bundle)`` and its one
    host read. Eager without ``graphs``: returns the new state (a
    NamedTuple of tensors) and the bundle read with ``.cpu()``. Through
    ``graphs``: ``state`` holds the static buffers, which the window
    overwrites with the new state (the kernels' outputs stay distinct
    allocations, copied in at the window's end), and the bundle goes
    through ``bundle_buf``; returns ``state`` itself and the bundle."""
    if graphs is None:
        new, bundle = fn(state)
        return new, bundle.cpu().tolist()

    def window():
        new, bundle = fn(state)
        for dst, src in zip(state, new):
            if dst is not None and dst is not src:
                dst.copy_(src)
        bundle_buf.copy_(bundle)

    graphs.run(key, window, bundle_buf.device)
    return state, graphs.read(bundle_buf)
