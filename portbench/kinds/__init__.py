"""Traffic kinds that come as files of their own.

A traffic file's ``kind`` names the class that serves it: ``rollout`` and
``scenario`` are ``portbench.mixes``' own (``mixes.KINDS``); any other
name is the ``Mix`` class of ``portbench/kinds/<kind>.py``, imported by
its path as ``portbench.kinds.<kind>``, so that it reaches the harness's
plain reference as ``from ..reference import ...``. Its judge lives in a
file of its own under ``portbench/reference/``, which imports nothing of
the program. A new kind adds files and edits none.

The harness (``portbench.run``, ``portbench.control``) reads these keys of
the traffic file: ``kind``; ``warm`` (the fewest warm-up requests);
``kernels`` (the sources under the program's ``csrc/`` built before
set-up); ``profile_kernels`` (substrings of the kernel names whose device
time a traced run sums as ``path_s``); ``roofline`` (optional, below).
Every other key is the kind's own.

``Mix(cfg, traffic, device)``: ``cfg`` the configuration file, ``traffic``
the traffic file, each as a dict; ``device`` the torch device this process
drives (``"cuda:<rank>"``; ``"cpu"`` in the CPU tests). Then, in this
order:

- ``build()``: set the program up from the configuration alone (no seed
  changes it). On a cell of more than one card every rank is a process of
  its own, started with the environment ``torchrun`` would give it
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``): the kind joins the program's process group as a user
  does, through ``parallel.sharded.init_distributed()`` and
  ``make_mesh()``.
- ``inputs(seed)``: draw the seed's inputs (every rank gets the run's
  seed; a rank draws its own share), then ``reset()``. The same seed
  gives the same inputs.
- ``request(i)``: serve request ``i`` (from 0, counting the warm-up's) and
  return once its answer is on the host or the device has finished it:
  the harness times this call. Every rank serves the same ``i`` in turn.
- ``reset()``: forget the warm-up: counts, kept answers and the draws that
  choose them start anew.
- ``sync()``: wait for the device.
- ``captures()``: CUDA graphs captured and device programs built so far;
  the warm-up runs until a request adds none.
- ``launches()``: the kernel launches counted so far by the program's
  counters that the traffic names.
- ``finish()``: the window's counts, read once after it has closed, as
  plain numbers: ``requests`` (requests served), ``attempted`` (QPs
  attempted), ``failed`` (QPs not certified solved, or with a non-finite
  answer), ``solved`` (``attempted - failed``), ``iters`` (solver
  iterations summed over the QPs) and ``iter_qps`` (the QPs ``iters``
  covers). The readers use them; on several ranks every count but
  ``requests`` is summed over the ranks, and ``requests`` is rank 0's.
- ``roofline(launches)`` (only where the traffic's ``roofline`` is set and
  is not ``"k2"``): called after a traced window and before ``free()``,
  with the launches the window made; returns ``{"kernel", "bound_s",
  "bound_kind", "ops"}``: the kernel, the least seconds the card could
  take for the window's work in it, whether operations or bytes bound
  that, and the operations counted. ``run_cell`` keeps it as
  ``rec["roofline"]`` for a reader beside the trace's ``path_s``.
- ``free()``: drop the program's state (the window has closed); the judge
  runs after it.
- ``judge()``: ``{"numbers": {name: value}, ...}``: each number compared
  against ``portbench/limits/<cell>.json``'s limit of that name, an upper
  limit; on several ranks the largest over the ranks decides. Other keys
  are logged.
- ``control()`` (optional; ``portbench.control --control`` only): after
  ``judge()``, the readings of the kind's control on the same kept
  answers. A kind without it has no control readings there.
"""
