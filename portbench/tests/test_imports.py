"""What the benchmark imports: never JAX nor the JAX package (compared by
whole top-level names, so the port's `omni_avsr_tpu_torch` is not
`omni_avsr_tpu`), and the plain reference nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from .tiny import PKG

FORBIDDEN = {"jax", "jaxlib", "flax", "omni_avsr_tpu"}


def _imports(path):
    """Absolute module names imported; a relative import as "." + its module."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module if node.level == 0 else "." + (node.module or "")


def test_no_module_imports_jax_or_the_jax_package():
    for f in PKG.rglob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_reference_imports_only_torch_numpy_and_the_standard_library():
    for f in (PKG / "reference").rglob("*.py"):
        for name in _imports(f):
            if name.startswith(".") and not name.startswith(".."):
                continue  # a sibling module of the reference itself
            top = name.split(".")[0]
            assert top in {"torch", "numpy", "__future__"} or top in sys.stdlib_module_names, (
                f, name)


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "q7b-eval-av-b32",
                          "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                         cwd=PKG.parent, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout and "correct" not in out.stdout
