"""reluqp_tpu_torch: the ReLU-QP solver on PyTorch, with CUDA kernels for
NVIDIA Hopper (H100).

An ADMM solver for box-constrained dense QPs whose iteration is compiled
at setup into an affine + clip layer per ρ in a precomputed ladder::

    import reluqp_tpu_torch as rq
    model = rq.ReLU_QP()
    model.setup(H, g, A, l, u)            # device defaults to "cuda"
    results = model.solve()

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that, they raise.

Importing the package turns TF32 off for float32 matrix products: the
residual, bias and plant products of the solve loop must run in full fp32
(reduced-precision residuals carry noise ~1e-2 that stalls the solver
short of eps_abs). Only the iteration tiers of ``iter_precision`` trade
precision, inside kernel K1.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .classes import QP, Info, Results, Settings  # noqa: E402
from .solver import ReLU_QP, prepare_bank  # noqa: E402
from .core.bank import Bank, DeviceQP, build_bank_np  # noqa: E402
from .core.iteration import SolveResult, solve_loop  # noqa: E402
from .core.ladder import initial_rho_index, setup_rhos  # noqa: E402
from . import convert, models  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ReLU_QP", "QP", "Settings", "Info", "Results",
    "Bank", "DeviceQP", "SolveResult", "solve_loop", "build_bank_np",
    "prepare_bank", "setup_rhos", "initial_rho_index",
    "convert", "models", "__version__",
]
