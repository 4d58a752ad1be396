"""The ctypes mirrors of the kernels' launch arguments against the C.

``ops/check_window.py`` passes ``_C1Args`` and ``_C2Args`` by address to
``csrc/check_window.cu``'s ``c1_check`` and ``c2_check``, which read them
as ``C1Args`` and ``C2Args``; ``ops/solve_kernel.py`` passes ``_K3Params``
to ``csrc/full_solve.cu``'s ``k3_full_solve`` (``K3Params``). A field added
on one side only, or out of order, shifts every field after it, and only
the card would show it. These tests parse the structs from the source and
hold the mirrors to them field by field (name, order, pointer / int /
float / double) and byte for byte.
"""
import ctypes
import re
from pathlib import Path

import pytest

from reluqp_tpu_torch.ops import check_window as cw
from reluqp_tpu_torch.ops import solve_kernel as sk

CSRC = Path(cw.__file__).resolve().parent.parent / "csrc"
SOURCES = {"C1Args": "check_window.cu", "C2Args": "check_window.cu",
           "K3Params": "full_solve.cu"}
MIRRORS = {"C1Args": cw._C1Args, "C2Args": cw._C2Args,
           "K3Params": sk._K3Params}
_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float", ctypes.c_double: "double"}
_SIZE = {"pointer": 8, "int": 4, "float": 4, "double": 8}


def c_fields(struct: str) -> list:
    """``(name, kind)`` of every field of ``struct`` in the source, in
    order; kind is "pointer", "int", "float" or "double"."""
    src = (CSRC / SOURCES[struct]).read_text()
    body = re.search(r"struct\s+%s\s*\{(.*?)\};" % struct, src, re.S)
    assert body, f"no struct {struct} in {SOURCES[struct]}"
    text = re.sub(r"//[^\n]*", "", body.group(1))
    fields = []
    for decl in text.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        parts = [p.strip() for p in decl.split(",")]
        head = re.match(r"(.*?)([\s*]*)(\w+)$", parts[0])
        base = head.group(1).strip()
        names = [head.groups()[1:]] + [
            re.match(r"([\s*]*)(\w+)$", p).groups() for p in parts[1:]]
        for stars, name in names:
            if "*" in stars:
                kind = "pointer"
            else:
                assert base in ("int", "float", "double"), (struct, decl)
                kind = base
            fields.append((name, kind))
    return fields


def mirror_fields(struct: str) -> list:
    return [(n, _KIND[t]) for n, t in MIRRORS[struct]._fields_]


@pytest.mark.parametrize("struct", sorted(MIRRORS))
def test_mirror_has_the_structs_fields_in_order(struct):
    assert mirror_fields(struct) == c_fields(struct)


@pytest.mark.parametrize("struct", sorted(MIRRORS))
def test_mirror_has_the_structs_size(struct):
    # natural alignment on a 64-bit host: the C compiler's layout
    off = 0
    for _, kind in c_fields(struct):
        size = _SIZE[kind]
        off = (off + size - 1) // size * size + size
    off = (off + 7) // 8 * 8
    assert ctypes.sizeof(MIRRORS[struct]) == off


@pytest.mark.parametrize("struct", sorted(MIRRORS))
def test_stamps_is_a_pointer_after_the_pointers(struct):
    fields = c_fields(struct)
    kinds = [k for _, k in fields]
    at = [n for n, _ in fields].index("stamps")
    assert kinds[at] == "pointer"
    # every pointer precedes the ints and doubles
    assert kinds[:at + 1] == ["pointer"] * (at + 1)


def test_c1_takes_no_scratch_and_no_ticket():
    # C1 runs in one thread-block cluster: no ticket, and a scratch (`part`)
    # only in its global variant, where a block's vectors and sums outgrow
    # its shared memory; C2 takes both
    fields = dict(c_fields("C1Args"))
    assert "tick" not in fields and fields["part"] == "pointer"
    assert {"part", "tick"} <= {n for n, _ in c_fields("C2Args")}
