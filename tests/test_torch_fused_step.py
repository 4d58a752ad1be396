"""Kernel K1's plain torch version against the JAX chunk kernel.

``fused_chunk_ref`` (what the CUDA kernel computes) against the JAX
package's Pallas ``fused_chunk`` run in interpret mode on the CPU, as
``tests/test_chunk_kernel.py`` runs it: Dp 128 and 640, 1 and 16 rows,
the first and last rung, all four precision tiers. The CUDA kernel
itself is compared with ``fused_chunk_ref`` on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``). K1 runs K5's
cluster kernel with every row on the one rung, so the same JAX kernel is
also held against K5's plain version on that view: the bank repeated over
the rows with a stride of 0 and a rung vector of that one rung.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reluqp_tpu.ops.fused_step import fused_chunk as j_fused_chunk
from reluqp_tpu.ops.fused_step import pad_dim as j_pad_dim

from reluqp_tpu_torch.ops.fused_step import (fused_chunk,
                                             fused_chunk_hetero_ref,
                                             fused_chunk_ref, pad_dim,
                                             pallas_chunk_runner, round_up)

N_RHO, STEPS = 3, 10
# "highest": both are plain fp32 and differ by summation order only.
# "high": both split W and y into bf16 hi/lo parts; fp32-grade (the JAX
#   test's own bound against the fp32 reference).
# "default"/"bf16": bf16-rounded inputs. JAX interprets "default" as a
#   plain fp32 dot on the CPU, so there the gap is the bf16 rounding
#   itself; ten steps of it on this contractive map stay below 1e-2
#   (measured ~1.5e-3).
TOL = {"highest": 1e-6, "high": 1e-4, "default": 1e-2, "bf16": 1e-2}


def _problem(dp, rows, seed=0):
    rng = np.random.default_rng(seed)
    # contractive W keeps the recurrence bounded over STEPS iterations
    wt = rng.standard_normal((N_RHO, dp, dp)) * (0.7 / np.sqrt(dp))
    b = 0.1 * rng.standard_normal((rows, dp))
    lo = np.full((rows, dp), -0.8)
    hi = np.full((rows, dp), 0.8)
    y = rng.standard_normal((rows, dp)) * 0.5
    return wt, b, lo, hi, y


@pytest.mark.parametrize("tier", ["highest", "high", "default", "bf16"])
@pytest.mark.parametrize("rung", [0, N_RHO - 1])
@pytest.mark.parametrize("rows", [1, 16])
@pytest.mark.parametrize("dp", [128, 640])
def test_plain_k1_matches_jax_kernel(dp, rows, rung, tier):
    arrs = _problem(dp, rows, seed=dp + rows)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_fused_chunk(
            *(jnp.asarray(a, jnp.float32) for a in arrs[:4]),
            jnp.asarray(arrs[4], jnp.float32), rung, STEPS, tier))
    wt, b, lo, hi, y = (torch.as_tensor(a, dtype=torch.float32)
                        for a in arrs)
    out = fused_chunk_ref(wt, b, lo, hi, y,
                          torch.tensor(rung, dtype=torch.int32), STEPS, tier)
    assert out.shape == (rows, dp) and out.dtype == torch.float32
    err = float(np.max(np.abs(out.numpy() - ref)))
    assert err <= TOL[tier], (tier, err)


@pytest.mark.parametrize("tier", ["highest", "high", "default", "bf16"])
@pytest.mark.parametrize("rows", [1, 16])
@pytest.mark.parametrize("dp", [128, 640])
def test_k1_as_k5_view_matches_jax_kernel(dp, rows, tier):
    """What K1's kernel computes on K5's path: every row against rung
    ``rung`` of the (N, Dp, Dp) bank, seen as K5's (R, N, Dp, Dp) bank with
    a stride of 0 over the rows and a rung vector of that rung."""
    rung = N_RHO - 1
    arrs = _problem(dp, rows, seed=dp + 3 * rows)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_fused_chunk(
            *(jnp.asarray(a, jnp.float32) for a in arrs[:4]),
            jnp.asarray(arrs[4], jnp.float32), rung, STEPS, tier))
    wt, b, lo, hi, y = (torch.as_tensor(a, dtype=torch.float32)
                        for a in arrs)
    view = wt.unsqueeze(0).expand(rows, *wt.shape)
    assert rows == 1 or view.stride(0) == 0
    rungs = torch.full((rows,), rung, dtype=torch.int32)
    out = fused_chunk_hetero_ref(view, b, lo, hi, y, rungs, STEPS, tier)
    assert out.shape == (rows, dp) and out.dtype == torch.float32
    err = float(np.max(np.abs(out.numpy() - ref)))
    assert err <= TOL[tier], (tier, err)
    # and K1's own plain version agrees with it
    torch.testing.assert_close(
        out, fused_chunk_ref(wt, b, lo, hi, y,
                             torch.tensor(rung, dtype=torch.int32), STEPS,
                             tier), rtol=0, atol=2 * TOL[tier])


def test_bf16_tiers_are_coarser_than_high():
    """The sanity check of the JAX test: "high" clearly beats bf16."""
    wt, b, lo, hi, y = (torch.as_tensor(a, dtype=torch.float32)
                        for a in _problem(128, 1, seed=1))
    rho = torch.tensor(1, dtype=torch.int32)
    exact = fused_chunk_ref(wt.double(), b.double(), lo.double(),
                            hi.double(), y.double(), rho, STEPS)
    err = {t: float((fused_chunk_ref(wt, b, lo, hi, y, rho, STEPS, t)
                     .double() - exact).abs().max())
           for t in ("highest", "high", "bf16")}
    assert err["highest"] < 1e-6 and err["high"] < 1e-4
    assert err["bf16"] > 10 * max(err["high"], 1e-9), err
    # a bank stored in bf16 always runs the bf16 tier
    out16 = fused_chunk_ref(wt.to(torch.bfloat16), b, lo, hi, y, rho, STEPS,
                            "highest")
    torch.testing.assert_close(
        out16, fused_chunk_ref(wt, b, lo, hi, y, rho, STEPS, "bf16"),
        rtol=0, atol=0)


@pytest.mark.parametrize("dp", [128, 896])
def test_padding_stays_inert(dp):
    """Zero weights and bias with ±inf bounds keep padded lanes at 0."""
    d = dp - 37
    rng = np.random.default_rng(dp)
    wt = np.zeros((N_RHO, dp, dp))
    wt[:, :d, :d] = rng.standard_normal((N_RHO, d, d)) * (0.7 / np.sqrt(d))
    b = np.zeros((1, dp))
    b[:, :d] = rng.standard_normal((1, d))
    lo = np.full((1, dp), -np.inf)
    hi = np.full((1, dp), np.inf)
    lo[:, :d // 2] = -0.5
    hi[:, :d // 2] = 0.5
    y = np.zeros((1, dp))
    y[:, :d] = rng.standard_normal((1, d))
    t = [torch.as_tensor(a, dtype=torch.float32) for a in (wt, b, lo, hi, y)]
    for tier in ("highest", "high", "bf16"):
        out = fused_chunk_ref(*t, torch.tensor(2, dtype=torch.int32), 25,
                              tier)
        assert torch.isfinite(out).all()
        assert not out[:, d:].any(), tier


def test_cpu_wrapper_runs_plain_version_without_counting():
    wt, b, lo, hi, y = (torch.as_tensor(a, dtype=torch.float32)
                        for a in _problem(128, 1))
    rho = torch.tensor(1, dtype=torch.int32)
    before = fused_chunk.launches
    out = fused_chunk(wt, b, lo, hi, y, rho, STEPS, "highest")
    assert fused_chunk.launches == before
    torch.testing.assert_close(
        out, fused_chunk_ref(wt, b, lo, hi, y, rho, STEPS, "highest"),
        rtol=0, atol=0)
    run = pallas_chunk_runner(wt, b.expand(N_RHO, -1).contiguous(), rho,
                              lo[0], hi[0], y[0], STEPS)
    torch.testing.assert_close(run, out[0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        fused_chunk_ref(wt, b, lo, hi, y, rho, STEPS, "fp8")


def test_pad_dim_matches_jax():
    for d in (1, 3, 127, 128, 129, 600, 643, 1000):
        assert pad_dim(d) == j_pad_dim(d)
    assert round_up(130, 128) == 256

