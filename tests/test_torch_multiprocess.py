"""``BatchedReLU_QP.setup(process_local=True)`` of the port across two
processes (``torch.distributed`` over gloo), as ``tests/test_multiprocess.py``
runs the JAX package's across two JAX processes.

Each rank (``tests/_torch_dist_worker.py``) is handed only its 4 rows of a
global batch of 8, in both regimes (one shared H/A; per-problem H/A), fp64
with Ruiz scaling and OSQP's scaled termination, eps 1e-6. In the ranks:
the solve against the fp64 oracle (x within 2e-4), ``objective()`` (the
global vector on every rank, each row within 1e-5 of ½xᵀHx + gᵀx),
``update(g)`` and ``update_matrices(H)`` with local rows and warm
re-solves against the oracle, then a shard-file checkpoint
(``<prefix>.proc<k>of2.npz``) restored onto the same layout and solved
bit-equal to the original. Here: the shard set merged into one process by
the port, and read by the JAX package's ``load_batched_solver`` (merged),
both solved to the oracle (2e-4) with the same status.
"""
import numpy as np
import pytest

from reluqp_tpu.utils.checkpoint import load_batched_solver as j_load

import _torch_dist_worker as W
from reluqp_tpu_torch.utils.checkpoint import load_batched_solver
from reluqp_tpu_torch.utils.problems import solve_qp_oracle

N_PROC = 2
X_TOL = 2e-4   # eps 1e-6 with scaled termination, against the oracle


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("process_local")
    wait = W.spawn(N_PROC, ("process_local_shared", "process_local_hetero"),
                   out)
    return out, wait


@pytest.fixture(scope="module")
def results(ranks):
    return ranks[1]()


def _oracle_check(mode, x):
    """Rows of the global batch after update(g) + update_matrices(H)."""
    for pid in range(N_PROC):
        H2, G2, As, L, U = W.local_problems(mode, pid, updated=True)
        for i in range(W.B_LOCAL):
            Hp = H2 if mode == "shared" else H2[i]
            Ap = As if mode == "shared" else As[i]
            x_star = solve_qp_oracle(Hp, G2[i], Ap, L[i], U[i])
            row = pid * W.B_LOCAL + i
            err = float(np.max(np.abs(x[row] - x_star)))
            assert err < X_TOL, (mode, row, err)


@pytest.mark.parametrize("mode", ["shared", "hetero"])
def test_two_process_batch(results, mode):
    """Both ranks hold the same global results: solved, against the
    oracle, and the objective of every row."""
    per_rank = results[f"process_local_{mode}"]
    for r in per_rank[1:]:
        for k in ("x", "status", "obj", "x4"):
            np.testing.assert_array_equal(r[k], per_rank[0][k])
    r = per_rank[0]
    assert r["x"].shape == (N_PROC * W.B_LOCAL, W.NX)
    assert (r["status"] == 1).all()
    _oracle_check(mode, r["x"])
    _oracle_check(mode, r["x4"])


@pytest.mark.parametrize("mode", ["shared", "hetero"])
def test_shard_files_merge_into_one_process(ranks, results, mode):
    """The port's shard set, merged in rank order into one solver on the
    CPU: the global batch, solved warm from the saved state."""
    prefix = str(ranks[0] / f"ckpt_{mode}")
    m = load_batched_solver(prefix, device="cpu")
    assert m.B_n == N_PROC * W.B_LOCAL and m.mesh is None
    if mode == "hetero":
        assert np.shape(m.rho_cap) == (m.B_n,)
    # a shard's own name pins the set as well
    m1 = load_batched_solver(f"{prefix}.proc1of{N_PROC}.npz", device="cpu")
    np.testing.assert_array_equal(m1.Y.numpy(), m.Y.numpy())
    res = m.solve()
    assert res.info.status.all()
    _oracle_check(mode, res.x.numpy())


@pytest.mark.parametrize("mode", ["shared", "hetero"])
def test_jax_reads_the_port_shard_files(ranks, results, mode):
    """The JAX package merges the port's shard set and solves it to the
    same status as the port's merged solver."""
    prefix = str(ranks[0] / f"ckpt_{mode}")
    j = j_load(prefix)
    assert j.B_n == N_PROC * W.B_LOCAL
    jr = j.solve()
    t = load_batched_solver(prefix, device="cpu").solve()
    np.testing.assert_array_equal(np.asarray(jr.info.status_code),
                                  t.info.status_code)
    assert np.asarray(jr.info.status).all()
    _oracle_check(mode, np.asarray(jr.x, np.float64))


def test_missing_and_ambiguous_shard_sets(ranks, results, tmp_path):
    """As the JAX package: no file and no shard set is a
    FileNotFoundError naming the shard pattern; two shard sets of
    different sizes under one prefix are refused."""
    with pytest.raises(FileNotFoundError, match="proc0of"):
        load_batched_solver(str(tmp_path / "none"), device="cpu")
    for n in (1, 2):
        for k in range(n):
            (tmp_path / f"x.proc{k}of{n}.npz").write_bytes(
                (ranks[0] / f"ckpt_shared.proc{k % 2}of2.npz").read_bytes())
    with pytest.raises(ValueError, match="ambiguous"):
        load_batched_solver(str(tmp_path / "x"), device="cpu")
