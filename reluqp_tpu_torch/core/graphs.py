"""A solve as one device program: captured pieces, loops the card exits.

The solve loops (``core.iteration.solve_loop``, ``core.batched``) and the
loop-path MPC rollouts (``models.mpc``) describe a solve as a *program*: a
sequence of ``Piece`` s (fixed device work on static tensors: the start
state, one check window, the result bundle), ``Loop`` s (a WHILE over a
body, run while an int32 flag that the pieces themselves write on the
device reads non-zero) and ``Cond`` s (an IF: the ``max_iter %
check_interval`` tail window). That is the port's counterpart of the JAX
package's compiled ``lax.while_loop`` and ``lax.scan`` bodies
(``reluqp_tpu/core/iteration.py`` ``solve_loop`` and
``run_refined_phases``, ``reluqp_tpu/core/batched.py``,
``reluqp_tpu/models/mpc.py``).

A ``WindowGraphs`` cache runs a program in one of three ways:

- ``"device"`` (the default on ``cuda``): every piece is captured once in a
  ``torch.cuda.CUDAGraph(keep_graph=True)`` and the program is built once
  into one instantiated CUDA graph (``csrc/graph_loop.cu``): the pieces as
  child graphs, each loop a conditional WHILE node whose body ends in a
  one-thread kernel that sets the node's condition from the flag, the tail
  an IF node. A solve is then one graph launch and, after it, one host
  read; the card decides every exit. A program's first use runs it on the
  host (as ``"windows"`` does, its pieces eager on the capture stream: it
  loads the kernels and sets up cuBLAS's workspace for that stream);
- ``"windows"`` (``device_exit = False``, ``verbose=True`` and the paths
  not yet covered: repack, a process group, tensor parallelism): the host
  walks the program, each piece one replay of its own graph (its first use
  eager, its second captured). It reads the program's control vector
  (``Program.ctl``: every flag, the iteration and open counts) once after
  each window and decides each loop and IF from that read; a start piece
  declares the flags it sets from host-known values (``Piece.sets``), so
  that no read precedes the first window;
- ``"eager"`` (the CPU, and a loop given ``_graphs=False``): the host walks
  the program and runs every piece eagerly.

The three run the same pieces on the same static tensors, so their results
are equal bit for bit.

What a graph may touch:

- the solve's state and per-solve vectors (``g``, bounds, biases, row
  maps), copied once at the solve's entry into static buffers this cache
  owns (``stage``), so that a later solve with new vectors replays the same
  graph;
- the solver's operands (banks, H, A, ρ ladders, residual operators),
  named in a piece's key by identity (``sig``: address, shape, strides,
  dtype), so that a new operand captures anew;
- host values baked into the launches (a window's length, the tier, the
  tolerances), which are in the key too.

All the graphs of one cache share one memory pool (a new one once the cache
holds no graph, as after ``clear``); everything a piece keeps is written
into static buffers allocated outside the pool, so the pool holds only
intermediates and pieces may run in any order. A capture, a build or a
launch that fails raises: nothing runs the solve another way in its place.

A replay calls no Python wrapper, so kernel wrappers count their launches
through ``on_launch``: the hooks a capture records run once per replay of
its piece, and after a device program's read once per execution of the
piece there (the program counts each loop's body executions on the card).

On the CPU the loops run eagerly unless the cache is given a ``capture``
factory (the tests' stand-in: it calls the recorded piece again on the same
buffers at every replay, which is a graph's binding) and, for the device
exit, a ``build`` factory (the tests' stand-in walks the program on the
host while each flag tensor reads true).
"""
from __future__ import annotations

import ctypes
import gc
import time
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["WindowGraphs", "Piece", "Loop", "Cond", "Program", "on_launch",
           "sig", "window_graphs"]

_recording: Optional[list] = None
# Bounds on what a cache keeps, least recently used first out: memory
# guards, not tuned. A solver's settings take two made entries (its state
# and its program) and three to six pieces; stale ones follow a new operand.
_MAX_WINDOWS = 64
_MAX_MADE = 16


def on_launch(hook: Callable[[], None]) -> None:
    """A launch's host-side bookkeeping (a launch counter): run ``hook``
    now, or, while a piece is being captured, once per execution of it
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


class Piece(NamedTuple):
    """Fixed device work on static tensors: ``fn()`` runs it, ``key`` names
    its graph (everything the launches bake in). ``sets``: ``(scalar,
    value)`` pairs, elements of the program's ``ctl`` that the piece leaves
    at host-known values (a start piece's flags), from which a host walk
    decides without a read. ``show``: ``(tensors, fn)``: a host walk reads
    ``tensors`` with the control vector after the piece, in one read, and
    hands their values to ``fn`` (``verbose``'s print)."""
    key: tuple
    fn: Callable[[], None]
    show: Optional[tuple] = None
    sets: tuple = ()


class Loop(NamedTuple):
    """A WHILE: ``body`` (pieces) runs while the int32 0-d ``flag`` reads
    non-zero; the pieces before the loop and the body write the flag."""
    flag: torch.Tensor
    body: tuple


class Cond(NamedTuple):
    """An IF: ``body`` runs once when ``flag`` reads non-zero."""
    flag: torch.Tensor
    body: tuple


def _ident(obj):
    if isinstance(obj, torch.Tensor):
        return ("tensor", id(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_ident(o) for o in obj)
    return obj


class _CudaGraph:
    """One piece captured in a ``torch.cuda.CUDAGraph`` on ``stream``, its
    memory from the pool ``pool`` (a ``graph_pool_handle``). The raw
    ``cudaGraph_t`` is kept (``raw()``) for the device programs; ``replay``
    instantiates the graph at its first call."""

    def __init__(self, fn, stream, pool):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        # no collection during the capture: a collected graph's destruction
        # is a CUDA call that invalidates a capture in progress
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                self.graph.capture_begin(pool=pool)
                try:
                    fn()
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(stream)

    def replay(self):
        self.graph.replay()

    def raw(self) -> int:
        return self.graph.raw_cuda_graph()


def _loop_lib():
    from ..ops.cuda_build import load
    lib = load("graph_loop")
    if not getattr(lib, "_gl_typed", False):
        vp, i, pvp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_void_p)
        u64 = ctypes.c_ulonglong
        for name, args in (
                ("gl_graph_create", [pvp]), ("gl_graph_destroy", [vp]),
                ("gl_add_child", [vp, vp, vp, pvp]),
                ("gl_handle", [vp, ctypes.POINTER(u64)]),
                ("gl_add_flag", [vp, vp, u64, vp, vp, i, pvp]),
                ("gl_add_cond", [vp, vp, u64, i, pvp, pvp]),
                ("gl_instantiate", [vp, pvp]), ("gl_launch", [vp, vp]),
                ("gl_exec_destroy", [vp])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i
        lib.gl_error_string.argtypes = [i]
        lib.gl_error_string.restype = ctypes.c_char_p
        lib._gl_typed = True
    return lib


class GraphProgram:
    """A program built into one instantiated CUDA graph
    (``csrc/graph_loop.cu``). ``nodes``: ``("graph", captured piece)``,
    ``("loop" | "cond", flag, count slot, body nodes)``; ``counts``: a
    float64 device tensor, one slot per loop and cond, to which each body
    execution adds one. Holds the pieces' graphs (and so their pool) as
    long as it lives, evicted from the cache or not; ``bodies`` are the
    raw graphs of its WHILE and IF bodies, in build order (owned by the
    program's graph: to inspect, not to launch). A step that fails
    raises."""

    def __init__(self, nodes, counts: torch.Tensor):
        self._lib = _loop_lib()
        self._nodes, self._counts = nodes, counts
        self._graph = self._exec = None
        self.bodies = []
        self._graph = self._call("graph create", "gl_graph_create")
        self._build(self._graph, nodes)
        self._exec = self._call("instantiate", "gl_instantiate",
                                self._graph)

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self._lib.gl_error_string(rc).decode()
            raise RuntimeError(f"device program {what} failed: CUDA error "
                               f"{rc} ({msg})")

    def _call(self, what, name, *args, out=ctypes.c_void_p):
        val = out()
        self._check(getattr(self._lib, name)(*args, ctypes.byref(val)), what)
        return val.value

    def _build(self, graph, nodes, dep=None):
        for node in nodes:
            if node[0] == "graph":
                dep = self._call("child graph", "gl_add_child", graph, dep,
                                 node[1].raw())
                continue
            kind, flag, slot, body = node
            loop = kind == "loop"
            handle = self._call("conditional handle", "gl_handle", graph,
                                out=ctypes.c_ulonglong)
            dep = self._call("flag kernel", "gl_add_flag", graph, dep,
                             handle, flag.data_ptr(), None, 1)
            body_g, node_p = ctypes.c_void_p(), ctypes.c_void_p()
            rc = self._lib.gl_add_cond(graph, dep, handle, int(loop),
                                       ctypes.byref(body_g),
                                       ctypes.byref(node_p))
            self._check(rc, f"{kind} node")
            dep = node_p.value
            self.bodies.append(body_g.value)
            last = self._build(body_g.value, body)
            self._call("count kernel", "gl_add_flag", body_g.value, last,
                       handle, flag.data_ptr(),
                       self._counts.data_ptr() + 8 * slot, int(loop))
        return dep

    def launch(self, stream: int) -> None:
        self._check(self._lib.gl_launch(self._exec, stream), "launch")

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is None:
            return
        if self._exec:
            lib.gl_exec_destroy(self._exec)
        if self._graph:
            lib.gl_graph_destroy(self._graph)


class _Window:
    __slots__ = ("graph", "hooks", "uses")

    def __init__(self):
        self.graph, self.hooks, self.uses = None, (), 0


class Program:
    """A solve as a program: its ``items`` (pieces, loops, conds) and
    ``ctl``, the static int32 vector whose elements are every flag of the
    items, which a host walk reads whole. Made once per solver and
    settings (``WindowGraphs.made`` holds it); once built it also holds its
    device program, the body counts the card keeps and the hooks settled
    from them."""
    __slots__ = ("items", "ctl", "known", "exec", "counts", "seen", "hooks",
                 "loops", "uses", "launches")

    def __init__(self, items, ctl: torch.Tensor):
        self.items, self.ctl = tuple(items), ctl
        self.known: dict = {}   # data_ptr -> value, of ctl's elements
        self.exec = self.counts = None
        self.seen: list = []
        self.hooks, self.loops = (), ()
        self.uses = self.launches = 0

    def value(self, t: torch.Tensor) -> Optional[int]:
        """The host value of ``t`` (an element of ``ctl``) where the last
        host walk's end knows it (from its last read or a piece's
        ``sets``, no piece having run since), else None."""
        return self.known.get(t.data_ptr())

    def settle(self, counts: list) -> None:
        """Run the recorded hooks once per execution of their piece since
        the last read: pieces outside a loop once per launch, a body's
        as often as the card ran it."""
        for _ in range(self.launches):
            for hook in self.hooks:
                hook()
        for slot, hooks in self.loops:
            for _ in range(int(counts[slot] - self.seen[slot])):
                for hook in hooks:
                    hook()
        self.seen = list(counts)
        self.launches = 0


class WindowGraphs:
    """A solver's captured pieces and device programs, their static
    buffers and pool.

    ``capture(fn, stream, pool)`` makes a replayable capture of ``fn``:
    ``None`` (the package's default) captures a CUDA graph on ``cuda`` and
    leaves the CPU eager; the tests pass a stand-in. ``build(nodes,
    counts)`` makes a launchable device program (``GraphProgram``'s
    signature): ``None`` builds one on ``cuda`` and has none on the CPU.
    ``device_exit = False`` runs every program window by window (the A/B
    of the device exit); ``check_kernels = False``, set before the cache's
    first solve, makes the programs it runs check each window with the
    plain torch check in place of kernels C1 and C2 (the A/B of those
    kernels). ``captures`` and ``replays`` count what this
    cache did (a device program's launch counts as a replay),
    ``programs`` the device programs it built, ``capture_seconds`` the
    host time its captures and builds took."""

    def __init__(self, capture=None, build=None, eager: bool = False):
        self._capture = capture
        self._build = build
        self._off = eager
        self.device_exit = True
        self.check_kernels = True
        self._windows: OrderedDict = OrderedDict()
        self._made: OrderedDict = OrderedDict()
        self._buffers: dict = {}
        self._host: dict = {}
        self._stream = self._pool = None
        self._live = 0          # captured graphs held (sharing the pool)
        self.captures = 0
        self.replays = 0
        self.programs = 0
        self.capture_seconds = 0.0

    def enabled(self, device) -> bool:
        """Whether pieces on ``device`` run through this cache."""
        return not self._off and (self._capture is not None
                                  or torch.device(device).type == "cuda")

    def mode(self, device, per_window: bool = False) -> str:
        """How a program on ``device`` runs: "device", "windows" or
        "eager" (module docstring)."""
        if not self.enabled(device):
            return "eager"
        if per_window or not self.device_exit:
            return "windows"
        if self._build is None and torch.device(device).type != "cuda":
            return "windows"
        return "device"

    def clear(self) -> None:
        """Drop every graph, program and buffer (a new setup: new
        operands)."""
        self._made.clear()
        self._windows.clear()
        self._buffers.clear()
        self._host.clear()
        self._live, self._pool = 0, None

    def made(self, key: tuple, make: Callable):
        """``make()``'s value (a solve's ``Program`` and its buffers, or
        its state), made once per ``key``: tensors in it (at any depth of
        tuples) by identity (the entry holds them, so an identity is not
        reused while it lives), everything else by value. A program
        evicted here takes its device program with it."""
        k = _ident(key)
        hit = self._made.get(k)
        if hit is None:
            hit = self._made[k] = (key, make())
            while len(self._made) > _MAX_MADE:
                self._made.popitem(last=False)
        else:
            self._made.move_to_end(k)
        return hit[1]

    def keys(self) -> list:
        """The keys of the pieces this cache holds, oldest first."""
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
        """``t`` copied into the static tensor ``name`` (None stays None;
        an eager cache reads ``t`` where it is). What a piece writes is
        made with ``buffer``, never staged."""
        if t is None or self._off:
            return t
        buf = self.buffer(name, t.shape, t.dtype, t.device)
        if buf is not t:
            buf.copy_(t)
        return buf

    def read(self, *ts, programs=()):
        """One host read of ``ts``: on ``cuda`` one copy of each into a
        pinned host buffer and one synchronisation. The device programs in
        ``programs`` have their body counts read in the same transfer and
        their hooks settled. Returns a numpy copy of each tensor (the one
        array for a single tensor)."""
        progs = [p for p in programs if p is not None and p.launches]
        every = list(ts) + [p.counts for p in progs]
        if not every[0].is_cuda:
            host = [t.detach().clone().numpy() for t in every]
        else:
            pinned = []
            for i, t in enumerate(every):
                key = (i, tuple(t.shape), t.dtype)
                h = self._host.get(key)
                if h is None:
                    h = self._host[key] = torch.empty(t.shape, dtype=t.dtype,
                                                      pin_memory=True)
                h.copy_(t, non_blocking=True)
                pinned.append(h)
            torch.cuda.current_stream(every[0].device).synchronize()
            host = [h.numpy().copy() for h in pinned]
        for p, counts in zip(progs, host[len(ts):]):
            p.settle(counts.tolist())
        return host[0] if len(ts) == 1 else host[:len(ts)]

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
        """Bookkeeping for a piece leaving the cache."""
        if w.graph is not None:
            self._live -= 1
            if self._live == 0:
                self._pool = None

    def _window(self, key) -> _Window:
        w = self._windows.get(key)
        if w is None:
            w = self._windows[key] = _Window()
            while len(self._windows) > _MAX_WINDOWS:
                self._dropped(self._windows.popitem(last=False)[1])
        else:
            self._windows.move_to_end(key)
        return w

    def run(self, key, fn: Callable[[], None], device) -> None:
        """Run the piece ``fn`` (which reads and writes static tensors
        only) under ``key``: eagerly at the key's first use, captured at
        its second, replayed from then on."""
        w = self._window(key)
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
        if self._capture is not None or torch.device(device).type != "cuda":
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

    # ---------------------------------------------------------------- #
    def program(self, prog: Program, device, per_window: bool = False,
                known: tuple = ()) -> Program:
        """Run ``prog`` on ``device`` in this cache's mode (``per_window``:
        walked from the host even where the device could exit). ``known``:
        ``(scalar, value)`` pairs of ``prog.ctl`` whose values the host
        holds at the start (a carried state's flags, which no piece of the
        program sets on the device): such a program is walked, never
        built. Returns ``prog``, to hand to ``read`` with the result, which
        settles the hooks of a device program launched."""
        mode = self.mode(device, per_window)
        if known and mode == "device":
            raise ValueError("a program whose start flags only the host "
                             "holds must be walked (per_window=True)")
        if mode == "eager":
            self._walk(prog, lambda p: p.fn(), known)
            return prog
        if mode == "windows":
            self._walk(prog, lambda p: self.run(p.key, p.fn, device), known)
            return prog
        prog.uses += 1
        if prog.uses == 1:
            # the first use walks the program on the host, its pieces
            # eager on the capture stream
            self._walk(prog, lambda p: self._eager(p.fn, device))
            return prog
        if prog.exec is None:
            self._make(prog, device)
        stream = (torch.cuda.current_stream(device).cuda_stream
                  if torch.device(device).type == "cuda" else None)
        prog.exec.launch(stream)
        prog.launches += 1
        self.replays += 1
        return prog

    def _walk(self, prog: Program, call, known: tuple = ()) -> None:
        prog.known.clear()
        prog.known.update((t.data_ptr(), int(v)) for t, v in known)
        _walk(prog.items, call, lambda extra=(): self._fetch(prog, extra),
              prog.known)

    def _fetch(self, prog: Program, extra=()) -> list:
        """One host read of ``prog.ctl`` (into what the walk knows) and of
        ``extra``; returns ``extra``'s values."""
        host = self.read(prog.ctl, *extra)
        ctl_h, rest = (host[0], host[1:]) if extra else (host, [])
        base, size = prog.ctl.data_ptr(), prog.ctl.element_size()
        prog.known.update((base + i * size, int(v))
                          for i, v in enumerate(ctl_h.tolist()))
        return rest

    def _make(self, prog: Program, device):
        """Capture every piece of ``prog`` not captured yet and build the
        program."""
        t0 = time.perf_counter()
        outside, slots = [], []
        tree = self._nodes(prog.items, outside, slots, device)
        counts = torch.zeros((max(len(slots), 1),), dtype=torch.float64,
                             device=device)
        build = self._build or GraphProgram
        prog.exec = build(tree, counts)
        prog.counts, prog.seen = counts, [0.0] * counts.shape[0]
        prog.hooks = tuple(outside)
        prog.loops = tuple((i, tuple(h)) for i, h in enumerate(slots))
        self.programs += 1
        self.capture_seconds += time.perf_counter() - t0

    def _nodes(self, items, hooks: list, slots: list, device) -> list:
        """``items`` as a program's nodes, each piece captured; the hooks
        of pieces at this level into ``hooks``, each body's into a new
        slot of ``slots``. (A method, not a nested function: a recursive
        closure is a reference cycle that would keep this cache alive for
        the cyclic collector.)"""
        out = []
        for it in items:
            if isinstance(it, Piece):
                w = self._window(it.key)
                if w.graph is None:
                    self._record(w, it.fn, device)
                hooks.extend(w.hooks)
                out.append(("graph", w.graph))
            else:
                slot, body_hooks = len(slots), []
                slots.append(body_hooks)
                body = self._nodes(it.body, body_hooks, slots, device)
                out.append(("loop" if isinstance(it, Loop) else "cond",
                            it.flag, slot, body))
        return out


def _walk(items, call, fetch, known: dict) -> None:
    """A program on the host: each piece through ``call`` (after which
    ``known``, the flags' host values by address, holds only the piece's
    ``sets``), each loop's and cond's flag from ``known`` or else from one
    ``fetch()`` of the control vector."""
    for it in items:
        if isinstance(it, Piece):
            call(it)
            known.clear()
            known.update((t.data_ptr(), int(v)) for t, v in it.sets)
            if it.show is not None:
                tensors, show = it.show
                show(fetch(tensors))
        elif isinstance(it, Loop):
            while _flag(it.flag, fetch, known):
                _walk(it.body, call, fetch, known)
        elif _flag(it.flag, fetch, known):
            _walk(it.body, call, fetch, known)


def _flag(flag: torch.Tensor, fetch, known: dict) -> bool:
    v = known.get(flag.data_ptr())
    if v is None:
        fetch()
        v = known[flag.data_ptr()]
    return v != 0


def window_graphs(graphs, device) -> WindowGraphs:
    """The cache a loop runs through: ``graphs`` as given (a solver's), a
    fresh one for this call when ``None``; a fresh one that runs eagerly
    (its buffers this call's own) when ``False`` or where ``graphs`` does
    not run ``device``'s pieces."""
    if graphs is None:
        graphs = WindowGraphs()
    if graphs is False or not graphs.enabled(device):
        return WindowGraphs(eager=True)
    return graphs
