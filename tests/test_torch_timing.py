"""The port's timing helpers (``reluqp_tpu_torch.utils.timing``) against the
JAX package's (``reluqp_tpu.utils.timing``).

The two-point fits and ``min_delta`` take host callables, so both packages
run the same synthetic timers and must return the same numbers (exactly:
the arithmetic is the same Python). ``Timer``, ``time_fn``, ``fetch`` and
``chain_timer`` run on CPU tensors, where nothing synchronizes; the CUDA
paths (``time_fn_events``, the synchronizations) run in ``chip_smoke.py``.
"""
import math

import pytest
import torch

from reluqp_tpu.utils import timing as jt

from reluqp_tpu_torch.utils import timing as tt


@pytest.mark.parametrize("slope", [1e-4, 1e-6, 1e-10])
def test_two_point_step_time_matches_jax(slope):
    """Measurable slope: returned; sub-jitter slope: the 8x stretch; below
    the noise floor even stretched: NaN, never a clamped number."""
    fit = lambda m: m.two_point_step_time(lambda x, n: 0.030 + n * slope,
                                          lambda j: j, 100, 600)
    ours, ref = fit(tt), fit(jt)
    if slope == 1e-10:
        assert math.isnan(ours) and math.isnan(ref)
    else:
        assert ours == ref and abs(ours - slope) < slope * 1e-4
    with pytest.raises(ValueError):
        tt.two_point_step_time(lambda x, n: 0.0, lambda j: j, 10, 10)


def test_two_point_survives_additive_congestion_as_jax():
    """The min-per-side estimator survives stalls that hit most samples."""
    def make():
        calls = [0]

        def timed(x, n):
            calls[0] += 1
            stall = 0.0 if calls[0] % 5 == 0 else 0.2
            return 0.030 + n * 1e-4 + stall
        return timed

    ours = tt.two_point_step_time(make(), lambda j: j, 100, 600, reps=5)
    ref = jt.two_point_step_time(make(), lambda j: j, 100, 600, reps=5)
    assert ours == ref and abs(ours - 1e-4) < 1e-8
    a, b = tt.entropy_rng(), tt.entropy_rng()
    assert a.randn(8).tolist() != b.randn(8).tolist()


def test_or_coarse_falls_back_to_a_finite_upper_bound():
    timed = lambda x, n: 0.030 + n * 1e-10
    for m in (tt, jt):
        v, how = m.two_point_step_time_or_coarse(timed, lambda j: j, 100, 600)
        assert how == "coarse" and v == timed(None, 600) / 600
    v, how = tt.two_point_step_time_or_coarse(
        lambda x, n: 0.030 + n * 1e-4, lambda j: j, 100, 600)
    assert how == "two_point" and abs(v - 1e-4) < 1e-8


def test_min_delta_takes_each_sides_minimum():
    lo, hi = iter([3.0, 1.0, 2.0]), iter([5.0, 9.0, 4.5])
    assert tt.min_delta(lambda: next(lo), lambda: next(hi), reps=3) == 3.5


def test_timer_and_time_fn_on_cpu_tensors():
    t = tt.Timer()
    x = torch.ones((64, 64))
    with t.section("mm", sync=x):
        x @ x
    s = t.summary()
    assert s["mm"]["n"] == 1 and s["mm"]["total"] > 0
    stats = tt.time_fn(lambda a: a @ a, x, warmup=1, reps=3)
    assert stats["reps"] == 3 and 0 <= stats["best"] <= stats["median"]
    assert tt.block_until_ready((x, {"y": x}))[0] is x


def test_fetch_and_time_fn_fetched():
    f = lambda y: y * 2.0
    assert tt.fetch((f(torch.ones((4, 4))), None)) == 32.0
    stats = tt.time_fn_fetched(f, lambda i: (torch.ones((4, 4)) * (i + 2),),
                               reps=3)
    assert stats["best"] >= 0 and stats["reps"] == 3
    assert stats["best"] <= stats["median"] <= stats["mean"] * 3
    with pytest.raises(ValueError):
        tt.fetch((1, 2))


def test_chain_timer_builds_each_length_once_on_its_own_input():
    """Each chain length is built once and warmed up on its OWN fresh
    input; the timed call runs the caller's value (as jit_chain_timer)."""
    built, seen = [], []

    def mk(n):
        built.append(n)
        return lambda x: x.sum() * n

    ctr = [100]

    def fresh(j):
        ctr[0] += 1
        return float(ctr[0])

    timed = tt.chain_timer(mk, lambda x: (seen.append(x)
                                          or torch.full((4,), x),), fresh)
    assert timed(1.0, 3) >= 0.0
    assert built == [3] and seen == [101.0, 1.0]
    timed(2.0, 3)
    assert built == [3] and seen[-1] == 2.0
    timed(4.0, 5)
    assert built == [3, 5] and seen[-2] == 102.0 and seen[-1] == 4.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tt.trace(str(tmp_path)) as prof:
        torch.ones((32, 32)) @ torch.ones((32, 32))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tt.time_fn_events(lambda: None)
