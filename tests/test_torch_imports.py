"""The port imports torch, never JAX: every module under rubiksnet_torch/
and chip_smoke.py, parsed with ``ast``, imports no ``jax``, ``jaxlib`` or
``rubiksnet_tpu`` (at any depth of the file, lazy imports included)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "rubiksnet_tpu")
FILES = sorted(
    [p for p in (REPO / "rubiksnet_torch").rglob("*.py")
     if "build" not in p.relative_to(REPO).parts]
    + [REPO / "chip_smoke.py"])


def imported_modules(tree):
    """Absolute module names a parsed file imports."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(REPO)) for p in FILES])
def test_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_check_sees_a_forbidden_import():
    tree = ast.parse("def f():\n    from rubiksnet_tpu.data import x\n"
                     "import os, jax.numpy as jnp\n")
    assert sorted(m.split(".")[0] for m in imported_modules(tree)
                  if m.split(".")[0] in FORBIDDEN) == ["jax", "rubiksnet_tpu"]


def test_every_port_module_is_covered():
    names = {str(p.relative_to(REPO)) for p in FILES}
    for module in ("rubiksnet_torch/data/device.py",
                   "rubiksnet_torch/scripts/test_models.py",
                   "rubiksnet_torch/ops/fused_block.py", "chip_smoke.py"):
        assert module in names
