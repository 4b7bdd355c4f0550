"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the references import nothing of the program."""
import ast

from perfbench import harness

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _modules():
    pb = harness.ROOT / "perfbench"
    return [p for p in pb.rglob("*.py") if "tests" not in p.relative_to(pb).parts]


def test_no_module_imports_jax_or_the_jax_package():
    bad = {str(p): sorted(set(_imports(p)) & BANNED) for p in _modules()}
    assert not {k: v for k, v in bad.items() if v}


def test_the_references_import_nothing_of_the_program():
    ref = harness.ROOT / "perfbench" / "reference"
    for p in ref.rglob("*.py"):
        assert "repro_torch" not in set(_imports(p)), p


def test_a_run_loads_neither_jax_nor_the_jax_package():
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = [%r, %r]; import torch; torch.set_num_threads(2); "
            "from perfbench import harness; from perfbench.tests import _small; "
            "harness.run_cell('lenet5-dfl.n1024', 5, 0.0, 0, device='cpu', "
            "cell_override=_small.lenet_cell('lenet5-dfl.n1024', 6, 12)); "
            "print(harness.banned_modules())") % (str(harness.ROOT), str(harness.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
