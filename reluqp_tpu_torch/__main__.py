"""Package self-test: ``python -m reluqp_tpu_torch [device]``.

Solves the canonical 3-variable/5-row QP (two equality rows as l == u) on
``cuda`` (or the device given), asserts x* = [2, -1, 1], then reports warm
per-solve throughput on that device.
"""
import sys
import time

import numpy as np


def main(device=None):
    from .ops.fused_step import fused_chunk
    from .solver import ReLU_QP
    from .utils.problems import canonical_qp

    qp = canonical_qp()
    model = ReLU_QP()
    model.setup(qp.H, qp.g, qp.A, qp.l, qp.u, eps_abs=1e-4, device=device)
    launches0 = fused_chunk.launches
    results = model.solve()
    x = results.x.detach().cpu().double().numpy()
    print("device:", model.settings.device, " status:", results.info.status,
          " iters:", results.info.iter)
    print("x =", x)
    assert results.info.status == "solved"
    assert np.allclose(x, qp.x_sol, atol=1e-3), x
    if model.settings.device.type == "cuda":
        assert fused_chunk.launches > launches0, "K1 was not launched"

    n = 100
    t0 = time.perf_counter()
    for _ in range(n):
        model.clear_primal_dual()
        model.solve()
    dt = (time.perf_counter() - t0) / n
    print(f"warm solve: {dt*1e3:.3f} ms  ({1/dt:.0f} solves/s, "
          f"runner={model._chunk_runner.__name__})")
    print("self-test OK")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
