"""The PyTorch port imports nothing of JAX or of the JAX package."""
import ast
import pathlib
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
