"""The PyTorch port imports nothing of JAX or of the JAX package, and its
CUDA sources build from the package alone."""
import ast
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "reluqp_tpu_torch"


def _port_modules():
    return sorted(
        "reluqp_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("")
                                       .parts).replace(".__init__", "")
        for p in PKG.rglob("*.py") if p.name != "__main__.py"
    )


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    assert "reluqp_tpu_torch.ops.fused_step" in mods
    code = (
        "import sys, importlib\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "importlib.import_module('reluqp_tpu_torch.__main__')\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'reluqp_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules and 'reluqp_tpu' not in "
        "sys.modules, sorted(sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "reluqp_tpu")]
    assert not bad, (path, bad)


CSRC = PKG / "csrc"


@pytest.mark.parametrize(
    "path", sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")),
    ids=lambda p: p.name)
def test_cuda_source_includes_only_its_own_headers(path):
    """A quoted include names a header beside it in csrc/; everything else
    is a system or CUDA toolkit header."""
    for inc in re.findall(r'#include\s+"([^"]+)"', path.read_text()):
        assert (CSRC / inc).is_file() and inc.endswith(".cuh"), (path, inc)


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """A change to a shared header renames every library, so K2, K3 and K6
    are rebuilt when ``solve_loop.cuh`` changes."""
    from reluqp_tpu_torch.ops import cuda_build
    for src in CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    names = ("solve_kernel", "full_solve", "fused_step", "fused_step_batched",
             "rollout_batched", "check_window")
    before = {n: cuda_build._lib_path(n) for n in names}
    assert "solve_loop.cuh" in (tmp_path / "full_solve.cu").read_text()
    with open(tmp_path / "solve_loop.cuh", "a") as f:
        f.write("// changed\n")
    after = {n: cuda_build._lib_path(n) for n in names}
    for n in names:
        assert before[n] != after[n], n
    assert cuda_build._lib_path("full_solve") == after["full_solve"]
