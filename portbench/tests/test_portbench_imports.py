"""No module of the benchmark imports JAX, flax or the JAX package
(top-level names compared whole: xlxmert_tpu_torch begins with
xlxmert_tpu), and the plain references import nothing of the program."""
import ast
import os

from portbench.lib.harness import FORBIDDEN

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_the_walk_compares_whole_top_level_names():
    assert "xlxmert_tpu_torch" not in FORBIDDEN
    assert "xlxmert_tpu" in FORBIDDEN and "jax" in FORBIDDEN


def test_no_benchmark_module_imports_jax_flax_or_the_jax_package():
    found = {p: imported_roots(p) & set(FORBIDDEN) for p in sources()}
    assert len(found) > 20
    assert not any(found.values()), found


def test_the_references_import_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            roots = imported_roots(os.path.join(ref, f))
            assert roots <= {"__future__", "contextlib", "math", "typing",
                             "numpy", "torch"}, (f, roots)
