"""The port stands alone: no file under src/repro_torch/, nor chip_smoke.py,
imports JAX or the JAX package (``repro``, ``repro.*``). An AST scan, so it
needs neither package importable."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files.extend(os.path.join(dirpath, n) for n in names if n.endswith(".py"))
    return sorted(files)


def _dynamic_import_name(node: ast.Call):
    """The module named by ``__import__("x")`` / ``import_module("x")``."""
    func = node.func
    name = getattr(func, "id", None) or getattr(func, "attr", None)
    if name in ("__import__", "import_module") and node.args \
            and isinstance(node.args[0], ast.Constant):
        return str(node.args[0].value)
    return None


def _imported_roots(source: str, filename: str):
    roots = []
    for node in ast.walk(ast.parse(source, filename)):
        if isinstance(node, ast.Import):
            roots.extend(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.append(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and _dynamic_import_name(node):
            roots.append(_dynamic_import_name(node).split(".")[0])
    return roots


def test_port_files_are_scanned():
    files = _port_files()
    assert os.path.isfile(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        roots = _imported_roots(f.read(), path)
    bad = sorted(set(roots) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scanner_catches_every_import_form():
    src = ("import jax.numpy as jnp\nfrom repro.chain import node\n"
           "import importlib\nimportlib.import_module('jaxlib.xla')\n"
           "__import__('jax')\nfrom repro_torch import tree\n")
    assert set(_imported_roots(src, "<t>")) == {"jax", "repro", "jaxlib",
                                                "repro_torch", "importlib"}
    assert "repro" not in _imported_roots("from repro_torch.core import x\n", "<t>")
