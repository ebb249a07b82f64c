"""Nothing of the benchmark imports JAX or the JAX package; top-level
names are compared whole, so kubernetes_tpu_torch is not kubernetes_tpu."""

import ast

from schedbench.run import FORBIDDEN, forbidden_modules
from schedbench.tests.small import ROOT


def test_top_level_names_compare_whole():
    assert forbidden_modules(["kubernetes_tpu_torch", "kubernetes_tpu_torch.ops"]) == []
    assert forbidden_modules(["kubernetes_tpu.ops.lattice"]) == ["kubernetes_tpu"]
    assert forbidden_modules(["jaxlib.xla_client", "jax", "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert forbidden_modules(["jaxtyping", "flaxen"]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "schedbench").rglob("*.py"):
        bad = set(_imports(path)) & (set(FORBIDDEN) | {"bench"})
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "window.py", "roofline.py"):
        assert "kubernetes_tpu_torch" not in set(_imports(ROOT / "schedbench" / name))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from schedbench.tests.small import run_small\n"
        "r = run_small(seconds=1.0)\n"
        "from schedbench.run import forbidden_modules\n"
        "print(forbidden_modules())\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
