"""Repo lint: ban negative-stride slicing / flips in device-code modules.

Round-3 root cause (prover/prover.py _suffix_prod_exclusive docstring): the
accelerator toolchain of that round miscompiled negative-stride reversed
views feeding log-depth scans — deterministically wrong values at non-tile-aligned lengths.  The fix
was a convention ("use mirrored positive-offset slices"); this test makes the
convention a CI guard: any `x[::-1]`-style slice or
`flip(...)` call in a module that can run on device fails the fast suite.
"""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "plonky2_ecdsa"

# Modules whose code is (or can be) traced into a device computation.  Host-
# only modules (circuit building, native oracles, serialization, CLI) are
# exempt: a host-side numpy reverse is safe.
DEVICE_DIRS = ("prover", "hash", "fields", "parallel")
DEVICE_FILES = ("circuit/gates.py", "circuit/algebra.py")


def _device_sources():
    out = []
    for d in DEVICE_DIRS:
        out.extend(sorted((PKG / d).rglob("*.py")))
    out.extend(PKG / f for f in DEVICE_FILES)
    assert out, "device module list is empty — layout changed?"
    return out


def _neg_const(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value < 0
    if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)):
        return True
    return False


def _violations(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Slice) and node.step is not None:
            if _neg_const(node.step):
                bad.append((node.lineno, "negative-stride slice"))
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if name in ("flip", "fliplr", "flipud"):
                bad.append((node.lineno, f"{name}() reversed view"))
    return bad


@pytest.mark.parametrize("path", _device_sources(),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_reversed_views_in_device_code(path):
    bad = _violations(path)
    assert not bad, (
        f"{path}: reversed views are banned in device code (miscompile, "
        f"see prover._suffix_prod_exclusive): {bad}")


def test_lint_catches_a_reversed_slice(tmp_path):
    """Self-test: the scanner actually flags the banned patterns."""
    f = tmp_path / "x.py"
    f.write_text("def f(a, xp):\n    return xp.flip(a[::-1], 0)\n")
    kinds = {k for _, k in _violations(f)}
    assert kinds == {"negative-stride slice", "flip() reversed view"}
